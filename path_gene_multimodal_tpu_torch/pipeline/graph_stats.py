"""Spatial graph analysis — the reference README's stage 6.

Counterpart of the JAX package's ``pipeline/graph_stats.py`` (numpy and
scipy only, so a copy with this package's imports): the reference README
(``README.md:117-138``) promises cell–cell interaction patterns,
tumor–immune spatial organization, graph statistics (degree, clustering,
centrality) and tissue architecture, which the reference's notebooks stop
short of. This module computes them over the ``CellGraph`` arrays
(``pipeline/graph.py``), host-side and vectorized (numpy +
scipy.sparse).

Artifacts: ``<stem>_graph_stats.json`` (summary scalars + per-type-pair
interaction enrichment) and ``<stem>_graph_node_stats.npz`` (per-node
degree / clustering / centrality / neighborhood composition).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import TYPE_CHECKING, Any

import numpy as np

from path_gene_multimodal_tpu_torch.config import TYPE_NAMES
from path_gene_multimodal_tpu_torch.core.artifacts import savez_fast
from path_gene_multimodal_tpu_torch.utils.log import get_logger

if TYPE_CHECKING:  # pragma: no cover
    from path_gene_multimodal_tpu_torch.pipeline.graph import CellGraph

# reference type ids (aggregated_hovernet_run.py:76-82): 1 neoplastic,
# 2 inflammatory — the canonical "tumor" and "immune" populations
TUMOR_TYPE = 1
IMMUNE_TYPE = 2


def adjacency(edge_index: np.ndarray, n_nodes: int):
    """Symmetric, deduplicated, zero-diagonal CSR adjacency from a (2, E)
    edge list (either orientation convention; ``ops.neighbors.radius_graph``
    emits both directions)."""
    from scipy import sparse

    if edge_index.size == 0:
        return sparse.csr_matrix((n_nodes, n_nodes), dtype=np.float64)
    src, dst = edge_index[0], edge_index[1]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    a = sparse.coo_matrix(
        (np.ones(len(src)), (src, dst)), shape=(n_nodes, n_nodes)
    ).tocsr()
    a = a + a.T
    a.data = np.ones_like(a.data)  # dedup double-counted directions
    return a


def degrees(a) -> np.ndarray:
    return np.asarray(a.sum(axis=1)).ravel().astype(np.int64)


def clustering_coefficients(
    a, row_chunk: int = 65536, deg: np.ndarray | None = None
) -> np.ndarray:
    """Local clustering coefficient per node: triangles through the node
    over possible neighbor pairs. ``(A·A)∘A`` keeps the *result* inside
    A's sparsity pattern, but the intermediate ``A·A`` holds ~N·d̄² entries
    (≈6 GB at 10⁶ nuclei, d̄≈20) — so the product runs in row chunks,
    bounding the transient to ``row_chunk·d̄²`` (the same chunked-host
    convention as ``ops.neighbors``'s distance recompute)."""
    n = a.shape[0]
    deg = (degrees(a) if deg is None else deg).astype(np.float64)
    if a.nnz == 0:
        return np.zeros(n, np.float64)
    # float32 spmm: per-node 2·triangle counts are bounded by d̄² (< 2²⁴
    # at any realistic degree), so f32 accumulation is EXACT here and the
    # csr_matmat moves half the intermediate bytes
    a32 = a.astype(np.float32)
    tri2 = np.empty(n, np.float64)  # 2·triangles per node
    for lo in range(0, n, row_chunk):
        hi = min(lo + row_chunk, n)
        rows = a32[lo:hi]
        tri2[lo:hi] = np.asarray((rows @ a32).multiply(rows).sum(axis=1)).ravel()
    denom = deg * (deg - 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.where(denom > 0, tri2 / denom, 0.0)
    return c


def eigenvector_centrality(
    a, iters: int = 200, tol: float = 1e-9
) -> np.ndarray:
    """Power iteration on ``A + I`` (networkx's shift): plain ``A`` has
    ±λ eigenvalue pairs on bipartite components (a hub-and-spokes star is
    the common WSI case), putting the iterate in a period-2 limit cycle;
    the +I shift breaks the symmetry without changing eigenvectors.
    Nodes in smaller components get ~0 weight, the standard convention.
    Normalized to unit L2 norm.

    Convergence uses networkx's criterion SHAPE — L1 iterate change
    < n·tol (networkx eigenvector_centrality) — with a tighter default
    (1e-9 vs networkx's 1e-6) to hold this module's dense-eig goldens.
    An absolute 1e-10 L2 test would never fire at WSI scale, so every
    call would pay all 200 matvecs."""
    n = a.shape[0]
    if n == 0:
        return np.zeros(0, np.float64)
    x = np.full(n, 1.0 / np.sqrt(n))
    if a.nnz == 0:
        return x
    for _ in range(iters):
        y = a @ x + x  # (A + I) @ x
        norm = np.linalg.norm(y)
        if norm == 0:
            return x
        y = y / norm
        if np.abs(y - x).sum() < n * tol:
            return y
        x = y
    return x


def neighborhood_composition(
    a, types: np.ndarray, n_types: int | None = None
) -> np.ndarray:
    """(N, K) fraction of each type among a node's radius-graph neighbors
    (rows of isolated nodes are all-zero). Types outside 1..K are ignored.
    This is the per-node "neighborhood composition" edge/node attribute the
    reference README names (stage 5)."""
    k = n_types or max(TYPE_NAMES)
    n = a.shape[0]
    onehot = np.zeros((n, k), np.float64)
    valid = (types >= 1) & (types <= k)
    onehot[np.nonzero(valid)[0], types[valid] - 1] = 1.0
    counts = a @ onehot  # (N, K) neighbor-type counts
    deg = counts.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(deg > 0, counts / deg, 0.0)
    return frac


def _upper_edges(a) -> tuple[np.ndarray, np.ndarray]:
    """Each undirected edge once as (src, dst) index arrays."""
    coo = a.tocoo()
    mask = coo.row < coo.col
    return coo.row[mask], coo.col[mask]


def interaction_enrichment(
    a,
    types: np.ndarray,
    n_types: int | None = None,
    n_perms: int = 200,
    seed: int = 0,
    edges: tuple[np.ndarray, np.ndarray] | None = None,
) -> dict[str, np.ndarray]:
    """Cell–cell interaction patterns: observed undirected edge counts per
    unordered type pair vs a type-label permutation null (the standard
    neighborhood-enrichment construction, cf. Keren 2018 / squidpy).

    Returns ``observed`` (K, K) symmetric counts, ``expected`` (analytic
    label-shuffle expectation: 2·E·qᵢ·qⱼ off-diagonal, E·qᵢ² diagonal,
    with qᵢ = type-i count over ALL nodes — so edges touching out-of-range
    types, which ``observed`` drops, deflate ``expected`` consistently),
    and — when ``n_perms > 0`` — permutation ``zscores`` (K, K).
    Permutations shuffle labels once per round and recount via one
    bincount pass: O(n_perms · E). ``edges`` accepts precomputed
    upper-triangle (src, dst) arrays to avoid re-materializing the COO."""
    k = n_types or max(TYPE_NAMES)
    src, dst = _upper_edges(a) if edges is None else edges
    e = len(src)
    # int32 edge indices + an unordered-pair-code LUT make the per-edge
    # work one gather + one table lookup + one bincount (invalid labels
    # route to a trash bin), fewer passes than a per-edge min/max/mask,
    # and the null loop below pays this n_perms times
    src32 = src.astype(np.int32, copy=False)
    dst32 = dst.astype(np.int32, copy=False)
    kk = k * k
    lut = np.full((k + 2) * (k + 2), kk, np.int32)
    for ti in range(1, k + 1):
        for tj in range(1, k + 1):
            lut[ti * (k + 2) + tj] = (min(ti, tj) - 1) * k + (max(ti, tj) - 1)

    def _counts(lbl: np.ndarray) -> np.ndarray:
        # int32 code arithmetic: (k+1)*(k+3) overflows int16 from k≈180
        l = np.clip(lbl, 0, k + 1).astype(np.int32)
        codes = lut[l[src32] * np.int32(k + 2) + l[dst32]]
        flat = np.bincount(codes, minlength=kk + 1)[:kk].reshape(k, k)
        return flat + np.triu(flat, 1).T  # symmetrize

    observed = _counts(types).astype(np.float64)

    # q over ALL nodes (Σq = valid fraction ≤ 1): the permutation null also
    # drops shuffled-onto-edges out-of-range labels, so E[observed] under
    # the null is 2·e·qᵢ·qⱼ, NOT 2·e·pᵢ·pⱼ with p normalized over valid
    valid = (types >= 1) & (types <= k)
    q = np.bincount(
        types[valid] - 1, minlength=k
    ).astype(np.float64) / max(len(types), 1)
    expected = 2.0 * e * np.outer(q, q)
    np.fill_diagonal(expected, e * q * q)

    out: dict[str, np.ndarray] = {"observed": observed, "expected": expected}
    if n_perms > 0 and e > 0:
        rng = np.random.default_rng(seed)
        perm_counts = np.empty((n_perms, k, k), np.float64)
        for t in range(n_perms):
            perm_counts[t] = _counts(rng.permutation(types))
        mu = perm_counts.mean(axis=0)
        sd = perm_counts.std(axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            z = np.where(sd > 0, (observed - mu) / sd, 0.0)
        out["zscores"] = z
    return out


def tumor_immune_metrics(
    graph: "CellGraph",
    a,
    tumor_type: int = TUMOR_TYPE,
    immune_type: int = IMMUNE_TYPE,
    edges: tuple[np.ndarray, np.ndarray] | None = None,
) -> dict[str, float | None]:
    """Tumor–immune spatial organization summary:

    - ``immune_infiltration_frac``: fraction of tumor nuclei with ≥1
      immune neighbor inside the interaction radius;
    - ``immune_to_tumor_dist_um_{mean,median}``: each immune nucleus's
      distance to its nearest tumor nucleus (host tree; the 10⁵-10⁶ scale
      is exactly ``ops.neighbors``'s host fast-path regime);
    - ``mixing_score``: immune–tumor edges over immune–immune edges
      (Keren 2018's mixing score; >1 = mixed, <1 = compartmentalized;
      ``None`` when there are no immune–immune edges to normalize by —
      the artifact JSON must stay strict-parseable, so no inf/NaN).
    """
    types = graph.types
    tumor = types == tumor_type
    immune = types == immune_type
    out: dict[str, float] = {
        "n_tumor": int(tumor.sum()),
        "n_immune": int(immune.sum()),
    }

    if tumor.any():
        immune_ind = np.zeros(len(types), np.float64)
        immune_ind[immune] = 1.0
        immune_neighbors = np.asarray(a @ immune_ind).ravel()
        out["immune_infiltration_frac"] = float(
            (immune_neighbors[tumor] > 0).mean()
        )
    if tumor.any() and immune.any():
        from scipy.spatial import cKDTree

        d, _ = cKDTree(graph.pos_um[tumor]).query(graph.pos_um[immune], k=1)
        out["immune_to_tumor_dist_um_mean"] = float(np.mean(d))
        out["immune_to_tumor_dist_um_median"] = float(np.median(d))

        src, dst = _upper_edges(a) if edges is None else edges
        ts, td = types[src], types[dst]
        it_edges = int(
            (((ts == immune_type) & (td == tumor_type))
             | ((ts == tumor_type) & (td == immune_type))).sum()
        )
        ii_edges = int(((ts == immune_type) & (td == immune_type)).sum())
        out["immune_tumor_edges"] = it_edges
        out["immune_immune_edges"] = ii_edges
        # None (JSON null), not inf: json.dumps would emit literal
        # `Infinity`, which strict JSON consumers reject
        out["mixing_score"] = (
            float(it_edges / ii_edges) if ii_edges
            else None if it_edges else 0.0
        )
    return out


def analyze_graph(
    graph: "CellGraph",
    out_dir: str | Path | None = None,
    stem: str = "slide",
    n_perms: int = 200,
    seed: int = 0,
) -> dict[str, Any]:
    """Full stage-6 analysis over a built ``CellGraph``. Returns the summary
    dict; when ``out_dir`` is given also writes ``<stem>_graph_stats.json``
    and ``<stem>_graph_node_stats.npz`` (per-node arrays)."""
    logger = get_logger()
    n = len(graph.node_ids)
    a = adjacency(np.asarray(graph.edge_index), n)

    deg = degrees(a)
    edges = _upper_edges(a)  # one COO pass shared by both O(E) consumers
    clust = clustering_coefficients(a, deg=deg)
    cent = eigenvector_centrality(a)
    comp = neighborhood_composition(a, graph.types)
    inter = interaction_enrichment(
        a, graph.types, n_perms=n_perms, seed=seed, edges=edges
    )
    ti = tumor_immune_metrics(graph, a, edges=edges)

    type_names = [TYPE_NAMES[t] for t in sorted(TYPE_NAMES)]
    summary: dict[str, Any] = {
        "n_nodes": int(n),
        "n_edges": int(a.nnz // 2),
        "mean_degree": float(deg.mean()) if n else 0.0,
        "max_degree": int(deg.max()) if n else 0,
        "isolated_frac": float((deg == 0).mean()) if n else 0.0,
        "mean_clustering": float(clust.mean()) if n else 0.0,
        "type_names": type_names,
        "type_counts": {
            TYPE_NAMES[t]: int((graph.types == t).sum()) for t in sorted(TYPE_NAMES)
        },
        "interaction_observed": inter["observed"].tolist(),
        "interaction_expected": inter["expected"].tolist(),
        "tumor_immune": ti,
    }
    if "zscores" in inter:
        summary["interaction_zscores"] = inter["zscores"].tolist()

    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        jp = out_dir / f"{stem}_graph_stats.json"
        # allow_nan=False: the artifact must stay strict-JSON parseable
        # (inf/NaN would serialize as bare Infinity/NaN literals)
        jp.write_text(json.dumps(summary, indent=2, allow_nan=False))
        npz = out_dir / f"{stem}_graph_node_stats.npz"
        savez_fast(
            npz,
            node_ids=graph.node_ids,
            degree=deg,
            clustering=clust,
            eigenvector_centrality=cent,
            neighborhood_composition=comp,
            composition_type_names=np.asarray(type_names),
        )
        summary["artifacts"] = {"stats_path": str(jp), "node_stats_path": str(npz)}
        logger.info(
            "graph stats: %d nodes, %d edges, mean degree %.2f, "
            "mean clustering %.3f → %s",
            n, summary["n_edges"], summary["mean_degree"],
            summary["mean_clustering"], jp,
        )
    return summary
