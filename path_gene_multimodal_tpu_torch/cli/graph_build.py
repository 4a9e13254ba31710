"""Cell-graph construction + stage-6 analysis CLI, in the port.

The JAX package's ``cli/graph_build.py`` with its arguments, exit codes
and outputs: it reads the WSI nuclei table the nuclei stage wrote
(``<stem>_hovernet_nuclei_wsi.parquet``/``.csv``), builds the kNN + radius
graphs (``pipeline.graph``; on the card unless ``--device cpu``) and runs
the stage-6 analysis (``pipeline.graph_stats``).

Outputs: ``<stem>_cell_graph.npz``, ``<stem>_graph_stats.json``,
``<stem>_graph_node_stats.npz``. Exit 2 on a missing or empty table, a
``--type-filter`` that leaves no nucleus, and no GPU without
``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

from path_gene_multimodal_tpu_torch.utils.log import get_logger


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nuclei", required=True,
                    help="nuclei table (.parquet or .csv) from the nuclei pipeline")
    ap.add_argument("--output", required=True, help="output directory")
    ap.add_argument("--stem", default=None,
                    help="artifact stem (default: nuclei filename stem "
                         "without the _hovernet_nuclei_wsi suffix)")
    ap.add_argument("--knn-k", type=int, default=None)
    ap.add_argument("--radius-um", type=float, default=None)
    ap.add_argument("--mpp", type=float, default=None)
    ap.add_argument("--type-filter", type=int, nargs="*", default=None,
                    help="restrict to these type ids (e.g. 1 2 = "
                         "neoplastic+inflammatory, notebook cell 12)")
    ap.add_argument("--n-perms", type=int, default=200,
                    help="permutations for interaction z-scores (0 = skip)")
    ap.add_argument("--device", default="cuda", help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)
    logger = get_logger()

    import pandas as pd
    import torch

    from path_gene_multimodal_tpu_torch.config import default_config
    from path_gene_multimodal_tpu_torch.pipeline.graph import build_cell_graph
    from path_gene_multimodal_tpu_torch.pipeline.graph_stats import analyze_graph

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        logger.error("no CUDA device: pass --device cpu to run on the CPU")
        return 2
    nuclei_path = Path(args.nuclei)
    if not nuclei_path.exists():
        logger.error("nuclei table not found: %s", nuclei_path)
        return 2
    if nuclei_path.suffix == ".parquet":
        nuclei = pd.read_parquet(nuclei_path)
    else:
        nuclei = pd.read_csv(nuclei_path)
    if len(nuclei) == 0:
        logger.error("nuclei table is empty: %s", nuclei_path)
        return 2

    stem = args.stem or nuclei_path.stem.removesuffix("_hovernet_nuclei_wsi")
    cfg = default_config().graph
    overrides = {
        k: v
        for k, v in (("knn_k", args.knn_k), ("radius_um", args.radius_um), ("mpp", args.mpp))
        if v is not None
    }
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    out_dir = Path(args.output)
    try:
        graph = build_cell_graph(nuclei, cfg, out_dir, stem,
                                 type_filter=args.type_filter or None, device=device)
    except ValueError as e:
        # e.g. --type-filter matched no rows: the same clean exit as a
        # missing or empty table, not a traceback
        logger.error("cannot build graph: %s", e)
        return 2
    summary = analyze_graph(graph, out_dir, stem, n_perms=args.n_perms)
    logger.info(
        "graph CLI done: %d nodes, %d edges, mean degree %.2f → %s",
        summary["n_nodes"], summary["n_edges"], summary["mean_degree"], out_dir,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
