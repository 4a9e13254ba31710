"""Legacy post-processing summaries.

A copy of the JAX package's ``pipeline/legacy.py``, the reference's
``postprocessing.py`` (SURVEY.md §2 C18) function for function, without
its module-level run (``:151-159`` runs a summary on import in the
reference, a documented bug that is not reproduced):

- ``summarize_tumor_area``: per-class tile counts and areas, and the tumor
  fraction (pandas only);
- ``tumor_bounding_boxes``: level-0 bounding boxes of the 4-connected
  regions of tumor tiles. The tiles are rasterised one pixel a tile
  (``ops/gridops.py``) and labelled by ``ops/components.py::
  label_components`` (the JAX package's XLA labeller: one fixpoint of at
  most 257 relaxations), on ``device``; the boxes are read on the host.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import pandas as pd
import torch

from path_gene_multimodal_tpu_torch.ops import components as cc
from path_gene_multimodal_tpu_torch.ops.gridops import rasterize_tiles, tiles_to_grid_shape


def summarize_tumor_area(
    df: pd.DataFrame,
    classes: Sequence[str],
    tumor_classes: Sequence[str],
    patch_size: int,
) -> pd.DataFrame:
    """Per-class tile counts + areas (px²) + fraction-of-annotated, plus a
    'TOTAL TUMOR' row (postprocessing.py:113-150 behavior)."""
    area_per_tile = float(patch_size) ** 2
    counts = df["predicted_class"].value_counts()
    total = int(counts.sum())
    rows = []
    for c in classes:
        n = int(counts.get(c, 0))
        rows.append(
            {
                "class": c,
                "num_tiles": n,
                "area_px2": n * area_per_tile,
                "fraction": n / total if total else 0.0,
            }
        )
    n_tumor = int(sum(counts.get(c, 0) for c in tumor_classes))
    rows.append(
        {
            "class": "TOTAL TUMOR",
            "num_tiles": n_tumor,
            "area_px2": n_tumor * area_per_tile,
            "fraction": n_tumor / total if total else 0.0,
        }
    )
    return pd.DataFrame(rows)


def tumor_bounding_boxes(
    df: pd.DataFrame,
    tumor_classes: Sequence[str],
    patch_size: int,
    device: str | torch.device = "cuda",
) -> pd.DataFrame:
    """Level-0 bounding boxes of connected tumor-tile regions
    (postprocessing.py:160-190): rasterize tumor tiles to the grid, label
    4-connected components on ``device``, one bbox row per component."""
    sel = df[df["predicted_class"].isin(list(tumor_classes))]
    if len(sel) == 0:
        return pd.DataFrame(columns=["region_id", "xmin", "ymin", "xmax", "ymax", "num_tiles"])
    coords = sel[["x", "y"]].to_numpy(np.int64)
    gw, gh, x0, y0 = tiles_to_grid_shape(coords, patch_size)
    grid = rasterize_tiles(
        torch.tensor(coords, device=device),
        torch.ones(len(coords), dtype=torch.float32, device=device),
        gw, gh, x0, y0, patch_size,
    )
    lbl = cc.label_components((grid > 0)[None], connectivity=1)[0]
    lbl, n = cc.compact_labels(lbl.cpu().numpy())
    rows = []
    for k in range(1, n + 1):
        ys, xs = np.nonzero(lbl == k)
        rows.append(
            {
                "region_id": k,
                "xmin": int(x0 + xs.min() * patch_size),
                "ymin": int(y0 + ys.min() * patch_size),
                "xmax": int(x0 + (xs.max() + 1) * patch_size),
                "ymax": int(y0 + (ys.max() + 1) * patch_size),
                "num_tiles": int(len(xs)),
            }
        )
    return pd.DataFrame(rows)
