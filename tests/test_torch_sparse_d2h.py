"""The port's sparse label and feature transport (``ops/instances.py``)
against the JAX package's, on ``tests/test_sparse_d2h.py``'s seeded labels:
the same counts, indices, ids and groups; the truncation contract; ids
beyond uint16, which the port keeps; and budget ladders that only rise."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from path_gene_multimodal_tpu.ops import instances as ji
from path_gene_multimodal_tpu_torch.ops import instances as ti
from path_gene_multimodal_tpu_torch.pipeline.nuclei_wsi import budget_ladders
from test_sparse_d2h import _random_labels


@pytest.mark.parametrize("b,budget", [(3, 4096), (4, 8192), (2, 100)])
def test_pack_unpack_groups_match_jax(b, budget):
    lbl = _random_labels(np.random.default_rng(b), b=b)
    jc, jidx, jids = ji.pack_labels_sparse(jnp.asarray(lbl), budget)
    tc, tidx, tids = ti.pack_labels_sparse(torch.from_numpy(lbl), budget)
    assert tc.dtype == torch.int32 and tidx.dtype == torch.int32 and tids.dtype == torch.int32
    assert int(tc) == int(jc) == int((lbl != 0).sum())
    # the whole budget, padding included
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids).astype(np.int32))
    if int(tc) <= budget:
        np.testing.assert_array_equal(ti.unpack_labels_sparse(tc, tidx, tids, lbl.shape), lbl)
        np.testing.assert_array_equal(ti.unpack_labels_sparse(tc, tidx, tids, lbl.shape),
                                      ji.unpack_labels_sparse(jc, jidx, jids, lbl.shape))
        got = ti.groups_from_sparse(tc, tidx, tids, *lbl.shape)
        want = ji.groups_from_sparse(jc, jidx, jids, *lbl.shape)
        assert len(got) == len(want) == b
        for g, w in zip(got, want):
            assert list(g) == list(w)  # the same ids, in the same order
            for k in w:
                np.testing.assert_array_equal(g[k][0], w[k][0])
                np.testing.assert_array_equal(g[k][1], w[k][1])


def test_truncation_contract():
    """Beyond the budget: the TRUE count, and the first ``budget`` true
    indices (ascending) with their ids."""
    lbl = np.zeros((2, 16, 16), np.int32)
    lbl[0, 3:13, 2:14] = 7
    lbl[1, ::3, ::2] = 9
    true_idx = np.flatnonzero(lbl.reshape(-1))
    cnt, idx, ids = ti.pack_labels_sparse(torch.from_numpy(lbl), budget=64)
    assert int(cnt) == len(true_idx) > 64
    assert idx.shape == (64,) and ids.shape == (64,)
    np.testing.assert_array_equal(idx.numpy(), true_idx[:64])
    np.testing.assert_array_equal(ids.numpy(), lbl.reshape(-1)[true_idx[:64]])
    jc, jidx, _ = ji.pack_labels_sparse(jnp.asarray(lbl), 64)
    assert int(jc) == int(cnt)
    np.testing.assert_array_equal(np.asarray(jidx), idx.numpy())


def test_empty_and_full_budget():
    lbl = np.zeros((1, 8, 8), np.int32)
    cnt, idx, ids = ti.pack_labels_sparse(torch.from_numpy(lbl), budget=16)
    assert int(cnt) == 0 and not idx.any() and not ids.any()
    assert ti.groups_from_sparse(cnt, idx, ids, 1, 8, 8) == [{}]
    lbl[:] = 3
    cnt, idx, ids = ti.pack_labels_sparse(torch.from_numpy(lbl), budget=64)
    assert int(cnt) == 64
    np.testing.assert_array_equal(idx.numpy(), np.arange(64))


def test_features_roundtrip_and_match_jax():
    lbl = _random_labels(np.random.default_rng(2))
    typ = (lbl > 0).astype(np.int32) * 2
    feats = ti.instance_features_batch(torch.from_numpy(lbl), torch.from_numpy(typ),
                                       max_instances=32)
    cnt, idx, packed = ti.pack_features_sparse(feats, budget=512)
    got = ti.unpack_features_sparse(cnt, idx, packed, lbl.shape[0], 32)
    live = feats["area"].numpy() > 0
    assert live.any()
    for k, v in feats.items():
        np.testing.assert_array_equal(got[k][live], v.numpy()[live])
        assert (got[k][~live] == 0).all()
    jfeats = ji.instance_features_batch(jnp.asarray(lbl), jnp.asarray(typ), max_instances=32)
    jc, jidx, _ = ji.pack_features_sparse(jfeats, budget=512)
    assert int(jc) == int(cnt)
    np.testing.assert_array_equal(np.asarray(jidx), idx.numpy())
    # truncated: the first live slots, the true count
    cnt, idx, _ = ti.pack_features_sparse(feats, budget=5)
    assert int(cnt) == int(live.sum()) > 5
    np.testing.assert_array_equal(idx.numpy(), np.flatnonzero(live.reshape(-1))[:5])


def test_ids_beyond_uint16_survive():
    """The JAX package narrows ids to uint16 and keys groups by
    window * 65536 + id; the port keeps int32 ids and groups on
    (window, id): window 0's id 65537 and window 1's id 1 (one JAX key)
    stay apart, and 70000 comes back as 70000."""
    lbl = np.zeros((2, 32, 32), np.int32)
    lbl[0, 2:6, 2:6] = 65537
    lbl[0, 10:12, 10:20] = 70000
    lbl[0, 20:22, 3:5] = 5
    lbl[1, 4:9, 4:9] = 1
    lbl[1, 20:30, 20:22] = 2**31 - 1
    cnt, idx, ids = ti.pack_labels_sparse(torch.from_numpy(lbl), budget=256)
    np.testing.assert_array_equal(ti.unpack_labels_sparse(cnt, idx, ids, lbl.shape), lbl)
    groups = ti.groups_from_sparse(cnt, idx, ids, 2, 32, 32)
    assert list(groups[0]) == [5, 65537, 70000] and list(groups[1]) == [1, 2**31 - 1]
    for b, g in enumerate(groups):
        for k, (ys, xs) in g.items():
            want = np.nonzero(lbl[b] == k)
            np.testing.assert_array_equal(ys, want[0])
            np.testing.assert_array_equal(xs, want[1])
    # the JAX encoding folds 65537 onto 1 (uint16) — the fault the port does not copy
    _, _, jids = ji.pack_labels_sparse(jnp.asarray(lbl), 256)
    assert 65537 not in set(np.asarray(jids).tolist())


@pytest.mark.parametrize("batch,window,slots", [(4, 256, 64), (1, 256, 512), (128, 256, 512),
                                                (2, 64, 16)])
def test_budget_ladders_rise(batch, window, slots):
    n_px, n_slots = batch * window * window, batch * slots
    lbl, feat = budget_ladders(n_px, n_slots)
    for ladder, whole in ((lbl, n_px), (feat, n_slots)):
        assert ladder == sorted(set(ladder)) and ladder[-1] <= whole and ladder[0] > 0
    if (batch, slots) == (4, 64):
        # the JAX ladder here is [max(256 // 16, 512), 256 // 4] = [512, 64]
        assert feat == [64, 256]
    if (batch, slots) == (1, 512):
        assert lbl == [4096, 8192, 32768] and feat == [128, 512]
