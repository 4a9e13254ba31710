"""The port's graph stage against the JAX package's on the CPU: ``knn``,
``radius_graph`` and ``combined_graphs`` give the same integer indices and
edges on the host route and on the device route (forced by patching
``HOST_TREE_MAX_N`` / ``HOST_TREE_CELL_BUDGET`` in both modules, as the
JAX tests do), on seeded points and on a grid whose distances tie;
distances equal on the host route and within f32 rounding on the device
route. ``build_cell_graph``, its exports and ``analyze_graph`` equal the
JAX package's on a seeded nuclei table, and each graph statistic on a
seeded graph."""

import json
import logging

import numpy as np
import pandas as pd
import pytest

import path_gene_multimodal_tpu.ops.neighbors as jnb
import path_gene_multimodal_tpu.pipeline.graph as jgraph
import path_gene_multimodal_tpu.pipeline.graph_stats as jstats
import path_gene_multimodal_tpu_torch.ops.neighbors as tnb
import path_gene_multimodal_tpu_torch.pipeline.graph as tgraph
import path_gene_multimodal_tpu_torch.pipeline.graph_stats as tstats
from path_gene_multimodal_tpu.config import GraphConfig as JGraphConfig
from path_gene_multimodal_tpu_torch.config import GraphConfig
from path_gene_multimodal_tpu_torch.utils.log import get_logger

CHUNKS = dict(q_chunk=64, db_chunk=128)


def _points(kind: str) -> np.ndarray:
    if kind == "grid":  # spacing 4: every point has 4 neighbours at one distance
        g = np.stack(np.meshgrid(np.arange(15), np.arange(20)), -1).reshape(-1, 2)
        return (g * 4 + 1000).astype(np.float32)
    return np.random.default_rng(0).uniform(0, 500, (300, 2)).astype(np.float32)


@pytest.fixture(params=["host", "device"])
def route(request, monkeypatch):
    if request.param == "device":
        for mod in (jnb, tnb):
            monkeypatch.setattr(mod, "HOST_TREE_MAX_N", 0)
            monkeypatch.setattr(mod, "HOST_TREE_CELL_BUDGET", 0)
    return request.param


def _same_dists(got, ref, route):
    if route == "host":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ["random", "grid"])
def test_neighbors_match_jax(route, kind):
    pts = _points(kind)
    for k, include_self in ((5, False), (6, True)):
        jd, ji = jnb.knn(pts, k=k, include_self=include_self, **CHUNKS)
        td, ti = tnb.knn(pts, k=k, include_self=include_self, device="cpu", **CHUNKS)
        np.testing.assert_array_equal(ti, ji)
        assert ti.dtype == ji.dtype
        _same_dists(td, jd, route)
    for r, cap in ((30.0, 16), (9.0, None)):
        je, jd = jnb.radius_graph(pts, r, max_degree=cap, **CHUNKS)
        te, td = tnb.radius_graph(pts, r, max_degree=cap, device="cpu", **CHUNKS)
        np.testing.assert_array_equal(te, je)
        assert te.dtype == je.dtype
        _same_dists(td, jd, route)
        ref = jnb.combined_graphs(pts, k=5, radius=r, max_degree=cap, **CHUNKS)
        got = tnb.combined_graphs(pts, k=5, radius=r, max_degree=cap, device="cpu", **CHUNKS)
        for a, b, is_dist in zip(got, ref, (True, False, False, True)):
            if is_dist:
                _same_dists(a, b, route)
            else:
                np.testing.assert_array_equal(a, b)


def test_device_route_ties_resolve_to_lower_id(monkeypatch):
    """On the grid each interior point has 4 neighbours at distance 4 and 4
    at 4·sqrt(2): the device route gives them nearest first, ties by
    ascending index, as ``lax.top_k`` does in the JAX scan. (The host route
    keeps cKDTree's order among ties, as the JAX package's host route
    does; ``test_neighbors_match_jax`` holds both.)"""
    monkeypatch.setattr(tnb, "HOST_TREE_MAX_N", 0)
    pts = _points("grid")
    d, i = tnb.knn(pts, k=8, device="cpu", **CHUNKS)
    interior = 3 * 15 + 3  # row 3, column 3
    np.testing.assert_array_equal(d[interior], [4] * 4 + [np.float32(4 * np.sqrt(2))] * 4)
    assert list(i[interior, :4]) == sorted(i[interior, :4])
    assert list(i[interior, 4:]) == sorted(i[interior, 4:])


def test_empty_and_single_point(route):
    for mod, kw in ((jnb, {}), (tnb, {"device": "cpu"})):
        d, i = mod.knn(np.zeros((0, 2), np.float32), k=5, **kw)
        assert d.shape == i.shape == (0, 5)
        d, i = mod.knn(np.array([[5.0, 5.0]], np.float32), k=5, **kw)
        assert i.tolist() == [[-1]] and np.isinf(d[0, 0])
        e, ed = mod.radius_graph(np.array([[0, 0], [1000, 1000]], np.float32), 5.0, **kw)
        assert e.shape == (2, 0) and ed.shape == (0,)
        out = mod.combined_graphs(np.zeros((0, 2), np.float32), **kw)
        assert out[2].shape == (2, 0)


def test_radius_cap_warning_device_route(monkeypatch):
    """Uncapped queries on the device route request one probe column and
    warn when nodes have more in-radius neighbours than the cap."""
    monkeypatch.setattr(tnb, "HOST_TREE_MAX_N", 0)
    monkeypatch.setattr(tnb, "DEVICE_RADIUS_CAP", 16)
    pts = np.random.default_rng(0).random((40, 2)).astype(np.float32) * 3.0
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    get_logger().addHandler(handler)
    try:
        ei, _ = tnb.radius_graph(pts, radius=10.0, device="cpu")
        tnb.combined_graphs(pts, k=3, radius=10.0, device="cpu")
        n_warned = len(records)
        tnb.radius_graph(pts, radius=10.0, max_degree=16, device="cpu")
    finally:
        get_logger().removeHandler(handler)
    assert n_warned == 2 and "40/40" in records[0].getMessage()
    assert len(records) == 2  # an explicit max_degree accepts the cap
    assert (np.bincount(ei[0], minlength=40) == 16).all()


def test_routing_constants_match_jax():
    for name in ("HOST_TREE_MAX_N", "HOST_TREE_CELL_BUDGET", "DEVICE_RADIUS_CAP"):
        assert getattr(tnb, name) == getattr(jnb, name), name


@pytest.fixture(scope="module")
def nuclei():
    rng = np.random.default_rng(7)
    n = 400
    return pd.DataFrame({
        "nuc_id": [f"n{i}" for i in range(n)],
        "type": rng.integers(0, 7, n),  # 0 and 6 are outside 1..5
        "wsi_centroid_x": rng.uniform(0, 3000, n),
        "wsi_centroid_y": rng.uniform(0, 2000, n),
        "area": rng.uniform(40, 200, n),
        "perimeter": rng.uniform(20, 70, n),
        "eccentricity": rng.uniform(0, 0.9, n),
        "solidity": rng.uniform(0.7, 1.0, n),
        "major_axis_length": rng.uniform(8, 20, n),
        "minor_axis_length": rng.uniform(4, 10, n),
        "orientation": rng.uniform(-1.5, 1.5, n),
    })


def _graph_fields(g):
    return {f: getattr(g, f) for f in ("node_ids", "pos_um", "types", "x", "knn_index",
                                       "knn_dist_um", "edge_index", "edge_attr")}


@pytest.mark.parametrize("type_filter", [None, (1, 2)])
def test_build_cell_graph_matches_jax(nuclei, tmp_path, type_filter):
    ref = jgraph.build_cell_graph(nuclei, JGraphConfig(), tmp_path / "jax", "s",
                                  type_filter=type_filter)
    got = tgraph.build_cell_graph(nuclei, GraphConfig(), tmp_path / "port", "s",
                                  type_filter=type_filter, device="cpu")
    assert got.feature_names == ref.feature_names
    for (name, a), b in zip(_graph_fields(got).items(), _graph_fields(ref).values()):
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert a.dtype == b.dtype, name
    with np.load(tmp_path / "port" / "s_cell_graph.npz") as zp, \
            np.load(tmp_path / "jax" / "s_cell_graph.npz") as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for f in zj.files:
            np.testing.assert_array_equal(zp[f], zj[f], err_msg=f)
    # the exports
    a, b = tgraph.to_networkx(got), jgraph.to_networkx(ref)
    assert sorted(a.edges(data="weight")) == sorted(b.edges(data="weight"))
    assert dict(a.nodes(data=True)) == dict(b.nodes(data=True))
    pa, pb = tgraph.to_pyg_data(got), jgraph.to_pyg_data(ref)
    assert type(pa) is type(pb) is dict
    for key in pb:
        np.testing.assert_array_equal(pa[key], pb[key])


def test_build_cell_graph_empty_raises():
    with pytest.raises(ValueError, match="no nuclei"):
        tgraph.build_cell_graph(pd.DataFrame({"type": []}), GraphConfig(), None, "s",
                                write_artifacts=False, device="cpu")


def test_analyze_graph_matches_jax(nuclei, tmp_path):
    ref_g = jgraph.build_cell_graph(nuclei, JGraphConfig(), None, write_artifacts=False)
    got_g = tgraph.build_cell_graph(nuclei, GraphConfig(), None, write_artifacts=False,
                                    device="cpu")
    ref = jstats.analyze_graph(ref_g, tmp_path / "jax", "s", n_perms=20)
    got = tstats.analyze_graph(got_g, tmp_path / "port", "s", n_perms=20)
    ref.pop("artifacts"), got.pop("artifacts")
    assert json.dumps(got, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert (tmp_path / "port" / "s_graph_stats.json").read_text() == \
        (tmp_path / "jax" / "s_graph_stats.json").read_text()
    with np.load(tmp_path / "port" / "s_graph_node_stats.npz", allow_pickle=True) as zp, \
            np.load(tmp_path / "jax" / "s_graph_node_stats.npz", allow_pickle=True) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for f in zj.files:
            np.testing.assert_array_equal(zp[f], zj[f], err_msg=f)


@pytest.fixture(scope="module")
def seeded_graph():
    """A random undirected edge list in both directions with duplicates and
    self loops (the adjacency builder must clean them), types including
    out-of-range ones, and a CellGraph-like holder for the tumour metrics."""
    rng = np.random.default_rng(11)
    n = 120
    src, dst = rng.integers(0, n, 500), rng.integers(0, n, 500)
    ei = np.stack([np.r_[src, dst, src[:3], [0]], np.r_[dst, src, dst[:3], [0]]]).astype(np.int64)
    types = rng.integers(0, 7, n).astype(np.int32)
    pos = rng.uniform(-200, 200, (n, 2))

    class G:
        pass

    g = G()
    g.types, g.pos_um, g.node_ids, g.edge_index = types, pos, np.arange(n), ei
    return n, ei, types, g


STAT_CASES = {
    "adjacency": lambda m, n, ei, t, g: m.adjacency(ei, n).toarray(),
    "degrees": lambda m, n, ei, t, g: m.degrees(m.adjacency(ei, n)),
    "clustering": lambda m, n, ei, t, g: m.clustering_coefficients(m.adjacency(ei, n)),
    "clustering_chunked": lambda m, n, ei, t, g: m.clustering_coefficients(
        m.adjacency(ei, n), row_chunk=17),
    "eigenvector_centrality": lambda m, n, ei, t, g: m.eigenvector_centrality(m.adjacency(ei, n)),
    "neighborhood_composition": lambda m, n, ei, t, g: m.neighborhood_composition(
        m.adjacency(ei, n), t),
    "upper_edges": lambda m, n, ei, t, g: m._upper_edges(m.adjacency(ei, n)),
    "interaction_enrichment": lambda m, n, ei, t, g: m.interaction_enrichment(
        m.adjacency(ei, n), t, n_perms=30, seed=3),
    "interaction_enrichment_many_types": lambda m, n, ei, t, g: m.interaction_enrichment(
        m.adjacency(ei, n), t * 7 % 40, n_types=40, n_perms=5),
    "tumor_immune_metrics": lambda m, n, ei, t, g: m.tumor_immune_metrics(g, m.adjacency(ei, n)),
    "empty_graph": lambda m, n, ei, t, g: (
        m.clustering_coefficients(m.adjacency(np.zeros((2, 0), np.int64), 5)),
        m.eigenvector_centrality(m.adjacency(np.zeros((2, 0), np.int64), 5))),
}


def _assert_same(a, b, where):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for key in a:
            _assert_same(a[key], b[key], f"{where}.{key}")
    elif isinstance(a, tuple):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=where)


@pytest.mark.parametrize("case", list(STAT_CASES))
def test_graph_stat_matches_jax(seeded_graph, case):
    got = STAT_CASES[case](tstats, *seeded_graph)
    ref = STAT_CASES[case](jstats, *seeded_graph)
    _assert_same(got, ref, case)
