"""Spatial cell-graph construction (README stages 5-6; notebook-only in the
reference — ``hovernet_tile_inference.ipynb`` cells 11-27).

Counterpart of the JAX package's ``pipeline/graph.py``. From the WSI
nuclei table (``pipeline.nuclei`` output):

1. px → µm conversion (``mpp=0.25``) and median-centering of coordinates
   (cells 13-17);
2. morphology feature matrix: regionprops columns already on the table +
   derived features — perimeter/area, compactness ``4πA/P²``, roundness
   ``4A/(π·major²)``, elongation ``major/minor`` — z-scored (cells 18-21);
3. kNN graph (``k=5``, cell 11): per-node neighbor indices + distances,
   exported as a networkx weighted graph (nodes carry pos/type);
4. radius graph (``r=40µm``, cells 23-27): ``edge_index``/``edge_attr``
   arrays + node features ``x = [one-hot type ‖ morph z-scores]`` — the
   ``torch_geometric.data.Data`` contract; a real ``Data`` object is
   returned when torch_geometric is importable, else the plain arrays
   (saved to ``<stem>_cell_graph.npz`` either way).

Neighbor search is ``ops.neighbors`` (host tree up to its thresholds, the
card beyond; ``device`` names the card).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import pandas as pd

from path_gene_multimodal_tpu_torch.config import TYPE_NAMES, GraphConfig
from path_gene_multimodal_tpu_torch.core.artifacts import savez_fast
from path_gene_multimodal_tpu_torch.ops.neighbors import combined_graphs
from path_gene_multimodal_tpu_torch.utils.log import get_logger

MORPH_COLUMNS = (
    "area", "perimeter", "eccentricity", "solidity",
    "major_axis_length", "minor_axis_length", "orientation",
)
DERIVED_COLUMNS = ("perimeter_area_ratio", "compactness", "roundness", "elongation")


@dataclass
class CellGraph:
    node_ids: np.ndarray          # (N,) nuc_id strings
    pos_um: np.ndarray            # (N, 2) median-centered µm coords
    types: np.ndarray             # (N,) int
    x: np.ndarray                 # (N, F) node features
    feature_names: list[str]
    knn_index: np.ndarray         # (N, k)
    knn_dist_um: np.ndarray       # (N, k)
    edge_index: np.ndarray        # (2, E) radius graph
    edge_attr: np.ndarray         # (E, 1) distances µm
    artifacts: dict


def morphology_features(df: pd.DataFrame) -> tuple[np.ndarray, list[str]]:
    """Morph columns + derived, z-scored (notebook cells 18-21)."""
    feats = {}
    for c in MORPH_COLUMNS:
        feats[c] = df[c].to_numpy(np.float64) if c in df.columns else np.zeros(len(df))
    area = feats["area"]
    perim = feats["perimeter"]
    major = feats["major_axis_length"]
    minor = feats["minor_axis_length"]
    feats["perimeter_area_ratio"] = perim / np.maximum(area, 1e-6)
    feats["compactness"] = 4 * np.pi * area / np.maximum(perim**2, 1e-6)
    feats["roundness"] = 4 * area / np.maximum(np.pi * major**2, 1e-6)
    feats["elongation"] = major / np.maximum(minor, 1e-6)
    names = list(MORPH_COLUMNS) + list(DERIVED_COLUMNS)
    mat = np.stack([feats[n] for n in names], axis=1)
    mu = mat.mean(axis=0, keepdims=True)
    sd = mat.std(axis=0, keepdims=True)
    z = (mat - mu) / np.maximum(sd, 1e-8)
    return z.astype(np.float32), [f"{n}_z" for n in names]


def build_cell_graph(
    nuclei: pd.DataFrame,
    cfg: GraphConfig = GraphConfig(),
    out_dir: str | Path | None = None,
    stem: str = "slide",
    type_filter: Sequence[int] | None = None,
    write_artifacts: bool = True,
    device="cuda",
) -> CellGraph:
    logger = get_logger()
    df = nuclei.reset_index(drop=True)
    if type_filter is not None:  # e.g. (1, 2) = neoplastic+inflammatory subgraph
        df = df[df["type"].isin(list(type_filter))].reset_index(drop=True)
    if len(df) == 0:
        raise ValueError("no nuclei to build a graph from")

    pos_px = df[["wsi_centroid_x", "wsi_centroid_y"]].to_numpy(np.float64)
    pos_um = pos_px * cfg.mpp
    pos_um = pos_um - np.median(pos_um, axis=0, keepdims=True)  # median-center

    z, znames = morphology_features(df)
    types = df["type"].to_numpy(np.int32)
    n_types = max(TYPE_NAMES)
    onehot = np.zeros((len(df), n_types), np.float32)
    valid_t = (types >= 1) & (types <= n_types)
    onehot[np.arange(len(df))[valid_t], types[valid_t] - 1] = 1.0
    x = np.concatenate([onehot, z], axis=1)
    feature_names = [f"type_{TYPE_NAMES[t]}" for t in sorted(TYPE_NAMES)] + znames

    k = min(cfg.knn_k, max(len(df) - 1, 1))
    # one query serves both graphs (kNN columns are a prefix of the radius
    # candidates)
    knn_d, knn_i, edge_index, edge_dist = combined_graphs(
        pos_um, k=k, radius=cfg.radius_um, device=device
    )

    artifacts: dict = {}
    if write_artifacts and out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        npz = out_dir / f"{stem}_cell_graph.npz"
        savez_fast(
            npz, pos_um=pos_um, types=types, x=x,
            knn_index=knn_i, knn_dist_um=knn_d,
            edge_index=edge_index, edge_attr=edge_dist[:, None],
            feature_names=np.asarray(feature_names),
        )
        artifacts["graph_path"] = npz
        logger.info("cell graph: %d nodes, %d radius edges → %s",
                    len(df), edge_index.shape[1], npz)

    return CellGraph(
        node_ids=df["nuc_id"].to_numpy(),
        pos_um=pos_um,
        types=types,
        x=x,
        feature_names=feature_names,
        knn_index=knn_i,
        knn_dist_um=knn_d,
        edge_index=edge_index,
        edge_attr=edge_dist[:, None].astype(np.float32),
        artifacts=artifacts,
    )


def to_networkx(graph: CellGraph):
    """kNN graph as a networkx weighted Graph (notebook cell 11 contract:
    nodes = nuc_id with pos/type attrs, edge weight = distance)."""
    import networkx as nx

    g = nx.Graph()
    g.add_nodes_from(
        (nid, {"pos": tuple(p), "cell_type": int(t)})
        for nid, p, t in zip(graph.node_ids, graph.pos_um, graph.types)
    )
    # vectorized edge extraction — the per-(i, j_pos) python double loop is
    # O(N·k) interpreter work and crawls at the 10⁵-10⁶-nuclei WSI scale
    n = len(graph.node_ids)
    idx = np.asarray(graph.knn_index)
    rr, cc = np.nonzero((idx >= 0) & (idx < n))
    g.add_edges_from(
        zip(
            graph.node_ids[rr],
            graph.node_ids[idx[rr, cc]],
            ({"weight": w} for w in graph.knn_dist_um[rr, cc].astype(float)),
        )
    )
    return g


def to_pyg_data(graph: CellGraph) -> Any:
    """torch_geometric ``Data(x, edge_index, edge_attr, pos)`` when
    available; otherwise a dict with the same keys (cells 23-27)."""
    try:
        import torch
        from torch_geometric.data import Data  # type: ignore

        return Data(
            x=torch.from_numpy(graph.x),
            edge_index=torch.from_numpy(graph.edge_index),
            edge_attr=torch.from_numpy(graph.edge_attr),
            pos=torch.from_numpy(graph.pos_um.astype(np.float32)),
        )
    except (ImportError, OSError):  # OSError: binary-incompatible
        # torch_geometric C extensions raise at load, not ImportError
        return {
            "x": graph.x,
            "edge_index": graph.edge_index,
            "edge_attr": graph.edge_attr,
            "pos": graph.pos_um.astype(np.float32),
        }
