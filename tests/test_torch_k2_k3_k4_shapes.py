"""K2, K3 and K4 at every shape their Pallas kernels take, and K7 past 1024
output channels, on the CPU.

- The plain versions against the JAX package at the shapes the card's
  first kernels did not take: K3 at 1, 2, 65, 128 and 256 levels, K4 at 1,
  10 and 16 types and 4,096 and 8,192 slots, K2 at 70,000 slots, K7 at
  cout 1408.
- The tiling classes choose the new routes at those shapes: K4's table
  route (``InstanceStatsTiling.route``), K3's instantiation with q in more
  than 6 bit-slices (``FloodTiling.nq``), K2's device slot tables
  (``CcSizesTiling.dev_tables``).
- Numpy replays of the new routes' designs equal the plain versions, and
  each mutant ``chip_smoke.py`` holds the card's check against differs,
  as the replay with the same fault does.
- The pipelines call K4 at 6 types whatever the model's type count: the
  port drops the votes of types 6 and up, as the JAX package's Pallas
  route, where its XLA route clips them to type 5.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from path_gene_multimodal_tpu.ops import instances as ji
from path_gene_multimodal_tpu.ops.pallas import decoder as jdec
from path_gene_multimodal_tpu.ops.pallas.cc_sizes import pallas_cc_sizes
from path_gene_multimodal_tpu.ops.pallas.flood import pallas_marker_watershed
from path_gene_multimodal_tpu.ops.pallas.instance_stats import (
    features_from_stats as j_features_from_stats,
    instance_stats_pallas,
    stats_center as j_stats_center,
)
from path_gene_multimodal_tpu_torch.ops import cc_sizes as tcc
from path_gene_multimodal_tpu_torch.ops import decoder as tdec
from path_gene_multimodal_tpu_torch.ops.components import INF, index_seeds, relax_fixpoint
from path_gene_multimodal_tpu_torch.ops.flood import FloodTiling, marker_watershed_plain
from path_gene_multimodal_tpu_torch.ops.instance_stats import (
    InstanceStatsTiling,
    _c_sum,
    features_from_stats,
    instance_stats_plain,
    stats_center,
)
from path_gene_multimodal_tpu_torch.ops.instances import instance_features_batch
from test_torch_decoder import _assert_elementwise
from test_torch_k3_k2_counts import _flood_inputs, _flood_replay
from test_torch_k4_runs import _run_sums

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

T = torch.from_numpy
K4_TABLE_MUTANTS = ("chunk_double", "first_stretch_votes", "slot0_no_votes")


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------ K3


@pytest.mark.parametrize("levels", [1, 2, 65, 128, 256])
def test_k3_plain_matches_pallas_at_levels(levels):
    """Labels equal the Pallas kernel's in interpret mode; the replay of
    the kernel's design with q in ``FloodTiling.nq`` bit-slices gives the
    same labels and the plain version's step and growth counts."""
    d, mk, m = _flood_inputs(levels, 2, 24, 40)
    c = torch.zeros(3, dtype=torch.int64)
    lbl = marker_watershed_plain(T(d), T(mk), T(m), levels=levels, counts=c).numpy()
    ref = np.asarray(pallas_marker_watershed(jnp.asarray(d), jnp.asarray(mk), jnp.asarray(m),
                                             levels=levels, interpret=True))
    np.testing.assert_array_equal(lbl, ref)
    got = [_flood_replay(d[i], mk[i], m[i], levels=levels) for i in range(len(d))]
    np.testing.assert_array_equal(np.stack([g[0] for g in got]), lbl)
    assert c.tolist() == [sum(g[1] for g in got), max(g[1] for g in got), sum(g[2] for g in got)]
    assert c[0] >= 2 * 2 * levels  # two phases a level, at least one step each


@pytest.mark.parametrize("levels, nq, shared_at_256", [
    (1, 6, True), (2, 6, True), (64, 6, True), (65, 7, True), (128, 7, True), (256, 8, True),
    (4096, 12, True), (2**31 - 1, 31, False)])
def test_flood_tiling_levels(levels, nq, shared_at_256):
    """Up to 64 levels the first instantiation's 6 slices (12 planes);
    above, (levels - 1).bit_length() slices in the wide one; the planes of
    a 256^2 tile fit shared memory up to 2^22 levels (28 planes)."""
    geo = FloodTiling(256, 256, levels)
    assert (geo.nq, geo.planes, geo.wide) == (nq, nq + 6, levels > 64)
    assert geo.shared == shared_at_256
    assert geo.scratch_words == (0 if shared_at_256 else (nq + 6) * 256 * 8)
    assert FloodTiling(256, 256, 2**22).shared and not FloodTiling(256, 256, 2**22 + 1).shared


def test_flood_tiling_refuses_no_level():
    with pytest.raises(ValueError, match="levels must be in 1"):
        FloodTiling(8, 8, 0)


def test_k3_slices6_mutant_fails_past_64_levels():
    """Keeping q in 6 slices past 64 levels changes the labels or counts
    of the sweep's tiles; at 64 levels it is the plain version."""
    d, mk, m = (T(a) for a in _flood_inputs(3, 2, 24, 40))
    for levels, differs in ((128, True), (64, False)):
        c = torch.zeros(3, dtype=torch.int64)
        lbl = marker_watershed_plain(d, mk, m, levels=levels, counts=c)
        ml, mc = chip_smoke._flood_mutant(d, mk, m, "slices6", levels=levels)
        assert (bool((ml != lbl).any()) or mc.tolist() != c.tolist()) == differs


# ------------------------------------------------------------ K4


def _ellipses(rng, b, h, w, n, max_id, num_types):
    """n ellipses a tile (ids in [1, max_id), some past the slots), each of
    one type with a fifth of its pixels another, on typed background."""
    li = np.zeros((b, h, w), np.int32)
    ti = rng.integers(0, num_types, (b, h, w)).astype(np.int32)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(b):
        for _ in range(n):
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            ry, rx = rng.integers(1, 6, 2)
            e = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
            li[i][e] = rng.integers(1, max_id)
            ti[i][e] = np.where(rng.random(int(e.sum())) < 0.8, rng.integers(0, num_types),
                                rng.integers(0, num_types, int(e.sum())))
    return li, ti


def _k4_inputs(num_types, slots, seed=0):
    rng = np.random.default_rng(seed + num_types + slots)
    return _ellipses(rng, 2, 32, 40, 40, slots + 200, num_types)


@pytest.mark.parametrize("slots", [4096, 8192])
@pytest.mark.parametrize("num_types", [1, 10, 16])
def test_k4_plain_matches_pallas_at_slots_and_types(num_types, slots):
    """instance_stats_plain against the Pallas kernel in interpret mode
    (counts, votes and extrema exact, moments within
    ``test_torch_k4_runs.py::test_replay_against_pallas_interpret``'s
    bar); the tiling takes the table route."""
    li, ti = _k4_inputs(num_types, slots)
    ps, pm = (a.numpy() for a in instance_stats_plain(T(li), T(ti), slots, num_types))
    js, jm = map(np.asarray, instance_stats_pallas(jnp.asarray(li), jnp.asarray(ti), slots,
                                                   num_types, interpret=True))
    assert ps.shape == js.shape == (2, slots, _c_sum(num_types))
    exact = [0, 1, 2] + list(range(6, js.shape[-1]))
    np.testing.assert_array_equal(ps[..., exact], js[..., exact])
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_allclose(ps[..., 3:6], js[..., 3:6], atol=1e-3, rtol=1e-5)
    assert InstanceStatsTiling(2, 32, 40, slots, num_types).route == "table"


@pytest.mark.parametrize("slots", [4096, 8192])
@pytest.mark.parametrize("num_types", [10, 16])
def test_k4_features_match_jax_at_slots_and_types(num_types, slots):
    """``instance_features_batch`` against the JAX package's, on the Pallas
    route's statistics (``features_from_stats``, the bar of
    ``test_torch_kernels_ref.py``) and on its XLA route
    (``use_pallas=False``): area, bbox and type exact, the rest within
    1e-3; orientation (an axis: modulo pi) and eccentricity on elongated
    instances (major - minor axis > 0.5), where the moments' f32 rounding
    cannot turn them."""
    li, ti = _k4_inputs(num_types, slots, seed=1)
    got = instance_features_batch(T(li), T(ti), max_instances=slots, num_types=num_types)
    js, jm = instance_stats_pallas(jnp.asarray(li), jnp.asarray(ti), slots, num_types,
                                   interpret=True)
    jp = j_features_from_stats(js, jm, num_types, center=j_stats_center(32, 40))
    jx = ji.instance_features_batch(jnp.asarray(li), jnp.asarray(ti), max_instances=slots,
                                    num_types=num_types, use_pallas=False)
    live = got["area"].numpy() > 0
    assert live[:, 1:].sum() > 40
    for ref in (jp, jx):
        assert set(ref) == set(got)
        for k in ("area", "bbox_xmin", "bbox_ymin", "bbox_xmax", "bbox_ymax", "type"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
        lam = (got["major_axis"].numpy() - got["minor_axis"].numpy()) > 0.5
        for k in ("centroid_x", "centroid_y", "major_axis", "minor_axis", "eccentricity"):
            sel = lam if k == "eccentricity" else np.ones_like(lam)
            np.testing.assert_allclose(got[k].numpy()[sel], np.asarray(ref[k])[sel], atol=1e-3,
                                       rtol=1e-4, err_msg=k)
        # an axis, so modulo pi (+pi/2 and -pi/2 are one orientation)
        turn = got["orientation"].numpy()[lam] - np.asarray(ref["orientation"])[lam]
        assert np.abs(np.angle(np.exp(2j * turn)) / 2).max() <= 1e-3


def test_k4_one_type_stats_and_no_features():
    """At one type the statistics carry no vote (c_sum 8, channels 6-7
    zero), as the Pallas kernel's; features raise, as the JAX package's
    (an argmax over no vote)."""
    li, ti = _k4_inputs(1, 4096)
    ps, _ = instance_stats_plain(T(li), T(ti), 4096, 1)
    assert ps.shape[-1] == 8 and not ps[..., 6:].any()
    with pytest.raises((RuntimeError, IndexError, ValueError)):
        features_from_stats(ps, torch.zeros((2, 4, 4096)), 1, center=stats_center(32, 40))
    with pytest.raises(ValueError, match="argmax of an empty sequence"):
        ji.instance_features_batch(jnp.asarray(li), jnp.asarray(ti), max_instances=4096,
                                   num_types=1, use_pallas=False)


def test_k4_pipelines_drop_the_votes_of_types_past_num_types():
    """Both nuclei pipelines call K4 at 6 types, whatever the model's type
    count: the votes of types 6 and up are dropped, as the Pallas route's
    one-hot drops them (the port's instance type equals it); the JAX XLA
    route clips them to type 5, which gives other types on this map."""
    rng = np.random.default_rng(12)
    li, ti = _ellipses(rng, 2, 32, 40, 30, 64, 12)
    got = instance_features_batch(T(li), T(ti), max_instances=64)
    js, jm = instance_stats_pallas(jnp.asarray(li), jnp.asarray(ti), 64, 6, interpret=True)
    jp = j_features_from_stats(js, jm, 6, center=j_stats_center(32, 40))
    jx = ji.instance_features_batch(jnp.asarray(li), jnp.asarray(ti), max_instances=64,
                                    use_pallas=False)
    np.testing.assert_array_equal(got["type"].numpy(), np.asarray(jp["type"]))
    assert (got["type"].numpy() != np.asarray(jx["type"])).any()


def test_k4_tiling_routes():
    """The cluster kernel up to its shared memory at 2..9 types; the table
    route past it (256^2 windows from 3,363 slots, 64-bit tiles past
    ~280^2 from 2,906), at other type counts, and at the path (5) shapes
    (1024^2 at 4,096 slots); its geometry."""
    for (b, h, w, s, nt), route in (((2, 256, 256, 3362, 6), "cluster"),
                                    ((2, 256, 256, 3363, 6), "table"),
                                    ((1, 300, 300, 2905, 6), "cluster"),
                                    ((1, 300, 300, 2906, 6), "table"),
                                    ((8, 1024, 1024, 512, 6), "cluster"),
                                    ((8, 1024, 1024, 4096, 6), "table"),
                                    ((4, 512, 512, 16384, 6), "table"),
                                    ((2, 256, 256, 512, 9), "cluster"),
                                    ((2, 256, 256, 512, 12), "table"),
                                    ((2, 256, 256, 512, 1), "table")):
        assert InstanceStatsTiling(b, h, w, s, nt).route == route, (b, h, w, s, nt)
    geo = InstanceStatsTiling(8, 1024, 1024, 4096, 6, 132)
    assert geo.table_bytes == 8 * 4096 * (40 + 10 * 4)
    assert geo.table_args() == (1, 132, 128)  # 16-px chunks by vector loads
    small = InstanceStatsTiling(1, 3, 7, 4096, 16, 132)
    assert small.table_args() == (0, 1, 16) and small.table_bytes == 4096 * (40 + 20 * 4)


def _row_moment_sum(n):
    """sum_{x < n} (2x - n)^2 as exact Python integers."""
    return sum((2 * x - n) ** 2 for x in range(n)) if n < 4096 else (n**3 + 2 * n) // 3


@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (46340, 46340), (1, 3_024_616),
                                   (1, 3_024_617), (3_024_617, 1), (2, 2_400_639),
                                   (2, 2_400_640)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_k4_refuses_only_tiles_whose_moments_pass_64_bits(shape):
    """Both routes sum a slot's moments in 64 bits, and so does the plain
    version: a tile is refused, by the tiling class and by the plain
    version alike, exactly where h * sum (2x - w)^2 or w * sum (2y - h)^2
    (a slot covering the whole tile) reaches 2^63. Square tiles pass up
    to 2^31 pixels; a single row up to 3,024,616 pixels."""
    h, w = shape
    assert _row_moment_sum(7) == (7**3 + 14) // 3
    over = h * _row_moment_sum(w) >= 2**63 or w * _row_moment_sum(h) >= 2**63
    maps = torch.zeros((1, 1, 1), dtype=torch.int32).expand(1, h, w)
    if over:
        with pytest.raises(ValueError, match="instance_stats: .*2\\^63"):
            InstanceStatsTiling(1, h, w)
        with pytest.raises(ValueError, match="instance_stats: .*2\\^63"):
            instance_stats_plain(maps, maps, 4)
    else:
        geo = InstanceStatsTiling(1, h, w, 4096)
        assert geo.route == "table" and InstanceStatsTiling(1, h, w).route == "cluster"
    assert over == (shape in ((1, 3_024_617), (3_024_617, 1), (2, 2_400_640)))


def _table_replay(li, ti, slots, num_types, mutant=None):
    """K4's table route on numpy maps: a thread's chunk of 16 pixels of a
    row cut into runs of one id, each run's closed-form sums added once
    (slot 0's summed apart and added once, which changes no total), its
    votes once per stretch of one type, then each slot as f32 once. A
    ``mutant`` (``K4_TABLE_MUTANTS``) breaks it as
    ``chip_smoke._k4_table_mutant`` says."""
    b, h, w = li.shape
    nv, chunk = num_types - 1, InstanceStatsTiling.chunk
    tab = np.zeros((b, 6, slots), np.int64)
    votes = np.zeros((b, max(nv, 1), slots), np.int64)
    ext = np.zeros((b, 4, slots), np.int64)
    ext[:, :2], ext[:, 2:] = 2**31 - 1, -(2**31)
    for img in range(b):
        for y in range(h):
            for xs in range(0, w, chunk):
                ids = [int(v) if 0 <= v < slots else -1 for v in li[img, y, xs : xs + chunk]]
                tys = [int(t) for t in ti[img, y, xs : xs + chunk]]
                start = 0
                for i in range(1, len(ids) + 1):
                    if i < len(ids) and ids[i] == ids[start]:
                        continue
                    sid, x0, x1 = ids[start], xs + start, xs + i - 1
                    if sid >= 0:
                        first_x = x0 - 1 if (mutant == "chunk_double" and start == 0 and xs > 0
                                             and li[img, y, xs - 1] == sid) else x0
                        tab[img, :, sid] += _run_sums(first_x, x1, y, w, h)
                        ext[img, :, sid] = [min(ext[img, 0, sid], x0), min(ext[img, 1, sid], y),
                                            max(ext[img, 2, sid], x1), max(ext[img, 3, sid], y)]
                        stretch = 0
                        for j in range(start, i):
                            if j > start and tys[j] != tys[j - 1]:
                                stretch += 1
                            t = tys[j]
                            if (not 1 <= t <= nv or (mutant == "first_stretch_votes" and stretch)
                                    or (mutant == "slot0_no_votes" and sid == 0)):
                                continue
                            votes[img, t - 1, sid] += 1
                    start = i
    sums = np.zeros((b, slots, _c_sum(num_types)), np.float32)
    sums[..., :3] = tab[:, :3].transpose(0, 2, 1).astype(np.float32)
    sums[..., 3:6] = (tab[:, 3:6].transpose(0, 2, 1).astype(np.float64) * 0.25).astype(np.float32)
    sums[..., 6 : 6 + nv] = votes[:, :nv].transpose(0, 2, 1).astype(np.float32)
    live = tab[:, None, 0] > 0
    e = np.stack([ext[:, 0], ext[:, 1], -ext[:, 2], -ext[:, 3]], 1).astype(np.float32)
    mins = np.where(live, e, np.float32(3e38)).astype(np.float32)
    return sums, mins


def _table_cases():
    rng = np.random.default_rng(23)
    return {"types_10_2x20x37": (*_ellipses(rng, 2, 20, 37, 16, 40, 10), 32, 10),
            "types_1_1x24x40": (*_ellipses(rng, 1, 24, 40, 12, 30, 1), 24, 1),
            "types_16_1x9x70": (*_ellipses(rng, 1, 9, 70, 10, 50, 16), 64, 16),
            "outside_ids_1x16x33": (rng.integers(-5, 40, (1, 16, 33)).astype(np.int32),
                                    rng.integers(-2, 14, (1, 16, 33)).astype(np.int32), 32, 12)}


@pytest.mark.parametrize("case", sorted(_table_cases()))
def test_k4_table_replay_equals_plain(case):
    li, ti, slots, nt = _table_cases()[case]
    ps, pm = instance_stats_plain(T(li), T(ti), slots, nt)
    rs, rm = _table_replay(li, ti, slots, nt)
    assert rs.view(np.int32).tolist() == ps.numpy().view(np.int32).tolist()
    assert rm.view(np.int32).tolist() == pm.numpy().view(np.int32).tolist()


@pytest.mark.parametrize("kind", K4_TABLE_MUTANTS)
def test_k4_table_mutants_differ(kind):
    """Each mutant of the table route changes the outputs, and
    ``chip_smoke.py``'s mutant gives what the replay with the same fault
    gives."""
    li, ti, slots, nt = _table_cases()["types_10_2x20x37"]
    want = instance_stats_plain(T(li), T(ti), slots, nt)
    got = chip_smoke._k4_table_mutant(T(li), T(ti), slots, nt, kind)
    assert not chip_smoke._bit_equal(got, want)
    es, em = _table_replay(li, ti, slots, nt, mutant=kind)
    np.testing.assert_array_equal(got[0].numpy(), es, err_msg=kind)
    np.testing.assert_array_equal(got[1].numpy(), em, err_msg=kind)


# ------------------------------------------------------------ K2


def _k2_masks(seed, b, h, w):
    rng = np.random.default_rng(seed)
    return rng.random((b, h, w)) < 0.45


def test_k2_plain_matches_pallas_at_70000_slots():
    """At 70,000 slots (past 0xFFFF, the first kernel's none-slot) labels,
    sizes and dense ids equal the Pallas kernel's; the clamp to the tile's
    pixels changes no output; the tiling keeps the tables in device
    memory."""
    m = _k2_masks(5, 2, 16, 24)
    lbl, sizes, dense, n_roots = tcc.cc_sizes_plain(T(m), s_slots=70_000, min_size=2)
    jl, js, jd = map(np.asarray, pallas_cc_sizes(jnp.asarray(m), s_slots=70_000, min_size=2,
                                                 interpret=True))
    np.testing.assert_array_equal(lbl.numpy(), jl)
    np.testing.assert_array_equal(sizes.numpy(), js)
    np.testing.assert_array_equal(dense.numpy(), jd)
    clamped = tcc.cc_sizes_plain(T(m), s_slots=16 * 24, min_size=2)
    for a, c in zip((lbl, sizes, dense, n_roots), clamped):
        assert torch.equal(a, c)
    assert tcc.CcSizesTiling(16, 24, 16 * 24).dev_tables is False
    assert tcc.CcSizesTiling(256, 256, 65_536).dev_tables


@pytest.mark.parametrize("h, w, s_slots, shared, dev_tables", [
    (256, 256, 11_776, True, False), (256, 256, 11_777, True, True),
    (256, 256, 65_535, True, True), (8, 8, 0xFFFF, True, True),
    (512, 512, 27_520, False, False), (512, 512, 27_521, False, True),
    (512, 512, 100_000, False, True), (1024, 1024, 4096, False, False)])
def test_k2_tiling_chooses_device_tables(h, w, s_slots, shared, dev_tables):
    """The shared route from 11,777 slots at 256^2 and the global route
    from 27,521 keep the slot counts and dense ids in device memory (2
    int32 words a slot and tile); so does the shared route at 0xFFFF slots
    or more; the main path's shapes keep them in shared memory."""
    geo = tcc.CcSizesTiling(h, w, s_slots)
    assert (geo.shared, geo.dev_tables) == (shared, dev_tables)
    assert geo.table_words == (2 * s_slots if dev_tables else 0)
    assert geo.smem_bytes <= tcc.cuda.SMEM_PER_BLOCK


def _tables_replay(mask, s_slots, min_size, shared_table=False):
    """K2's slot stage over its relaxation's labels with the tables in
    device memory: roots ranked row-major, each pixel's slot (its root's
    rank under s_slots), the counts added into the tile's table (one table
    for every tile with ``shared_table``, the mutant), dense ids by an
    inclusive count of the kept slots. Returns (sizes, dense, n_roots)."""
    b, h, w = mask.shape
    lbl, _ = relax_fixpoint(T(mask), index_seeds(T(mask)), 1, tcc.MAX_ITERS)
    lbl = lbl.numpy().reshape(b, h * w)
    tables = np.zeros((b, 2, s_slots), np.int64)
    slots = np.full((b, h * w), -1)
    n_roots = []
    for t in range(b):
        m = mask[t].reshape(-1)
        roots = np.flatnonzero(m & (lbl[t] == np.arange(h * w)))
        n_roots.append(len(roots))
        rank = np.full(h * w, -1)
        rank[roots] = np.arange(len(roots))
        fg = m & (lbl[t] < INF)
        slots[t, fg] = rank[lbl[t, fg]]
        slots[t, slots[t] >= s_slots] = -1
        np.add.at(tables[0 if shared_table else t, 0], slots[t][slots[t] >= 0], 1)
    sizes = np.zeros((b, h * w), np.int64)
    dense = np.zeros((b, h * w), np.int64)
    for t in range(b):
        cnt = tables[0 if shared_table else t, 0]
        keep = (cnt >= min_size) & (np.arange(s_slots) < min(n_roots[t], s_slots))
        dn = np.cumsum(keep) * keep
        on = slots[t] >= 0
        sizes[t, on] = cnt[slots[t, on]]
        dense[t, on] = dn[slots[t, on]]
    return sizes.reshape(b, h, w), dense.reshape(b, h, w), np.array(n_roots)


@pytest.mark.parametrize("s_slots", [3, 40, 600])
def test_k2_tables_replay_equals_plain(s_slots):
    """At a few slots (tiles overflow), some and all of a tile's 600 pixels
    (what any larger count is clamped to)."""
    m = _k2_masks(8, 3, 20, 30)
    _, sizes, dense, n_roots = tcc.cc_sizes_plain(T(m), s_slots=s_slots, min_size=2)
    rs, rd, rn = _tables_replay(m, s_slots, 2)
    np.testing.assert_array_equal(rs, sizes.numpy())
    np.testing.assert_array_equal(rd, dense.numpy())
    np.testing.assert_array_equal(rn, n_roots.numpy())


def test_k2_shared_table_mutant_differs():
    """Counting every tile into one table changes sizes and dense ids of
    a batch of 3; ``chip_smoke.py``'s mutant gives the replay's."""
    m = _k2_masks(9, 3, 20, 30)
    want = tcc.cc_sizes_plain(T(m), s_slots=600, min_size=2)
    got = chip_smoke._cc_table_mutant(T(m), 600, min_size=2)
    assert any(not torch.equal(a, b) for a, b in zip(got, want))
    rs, rd, _ = _tables_replay(m, 600, 2, shared_table=True)
    np.testing.assert_array_equal(got[1].numpy(), rs)
    np.testing.assert_array_equal(got[2].numpy(), rd)
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])


# ------------------------------------------------------------ K7 past 1024


def test_k7_plain_matches_pallas_at_cout_1408():
    """K7's plain version at cout 1408 (ConvNeXtV2-huge's stage width)
    equals the Pallas kernel in interpret mode within
    ``test_torch_decoder.py``'s bar; the tiling runs it on the any route
    in four 384-column chunks."""
    rng = np.random.default_rng(1408)
    cx, cs, cout = 64, 32, 1408

    def n(shape, scale=1.0, loc=0.0):
        return (loc + scale * rng.standard_normal(shape)).astype(np.float32)

    x, skip = n((1, 4, 4, cx)), n((1, 4, 4, cs))
    wk = n((3, 3, cx + cs, cout), (9 * (cx + cs)) ** -0.5)
    b, g, lb = n(cout, 0.1), n(cout, 0.1, 1.0), n(cout, 0.1)
    ref = jdec.fused_decoder_conv(*map(jnp.asarray, (x, skip, wk, b, g, lb)), interpret=True)
    got = tdec.decoder_conv(*map(T, (x, skip, wk, b, g, lb)))
    _assert_elementwise(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    geo = tdec.DecoderConvTiling(1, 4, 4, cx, cs, cout)
    assert (geo.route, geo.n_tile, geo.n_chunks, geo.raw) == ("any", 384, 4, True)
    assert tdec.DecoderConvTiling(2, 16, 16, 2816, 1408, 1408).n_chunks == 4
