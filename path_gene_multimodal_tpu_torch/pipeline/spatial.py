"""Step 5/8 — spatial join of annotations with tile coordinates + TME ROI.

A copy of the JAX package's ``pipeline/spatial.py``: the reference's
``load_annotations_with_coords`` (``load_annotation_with_coordinates.py:9-232``)
with the shapely ROI loop replaced by the distance reduction of
``ops.tme`` on the device:

1. read annotations CSV (add ``tile_index`` from row order if missing,
   ref ``:118-119``);
2. read tile coords from the tessellation H5 (all 5 schema variants,
   ``core.artifacts``);
3. left-merge on ``tile_index`` (ref ``:173``);
4. ``png_path`` = ``patches/{x}_{y}.png`` when a patches dir exists
   (ref ``:176-180``; legacy ``{tile_index}.png`` behind the compat flag);
5. ``predicted_class`` = argmax over class columns (ref ``:186``);
6. ``in_tme_roi``: tile box within ``margin`` of the tumor-box union
   (ref ``:195-222``) — including the 508-px patch-size quirk, which is the
   default here (``cfg.tme.roi_patch_size``).

Output: ``<stem>_annotations_with_coords.csv`` — schema per SURVEY.md §2.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd
import torch

from path_gene_multimodal_tpu_torch.config import CompatConfig, PipelineConfig, resolve_tile_png_name
from path_gene_multimodal_tpu_torch.core.artifacts import read_tessellation_h5
from path_gene_multimodal_tpu_torch.ops.tme import tme_roi_flags
from path_gene_multimodal_tpu_torch.utils.log import get_logger


def load_annotations_with_coords(
    annotations_csv: str | Path,
    tiles_h5_path: str | Path,
    classes: list[str],
    tumor_classes: list[str],
    out_dir: str | Path,
    stem: str,
    patch_size: int = 508,
    tme_margin_factor: float = 2.0,
    patches_dir: str | Path | None = None,
    add_tme_roi: bool = True,
    compat: CompatConfig | None = None,
    save_merged: bool = True,
    device: str | torch.device = "cuda",
) -> pd.DataFrame:
    annotations_csv = Path(annotations_csv)
    tiles_h5_path = Path(tiles_h5_path)
    if not annotations_csv.exists():
        raise FileNotFoundError(f"Annotations CSV not found: {annotations_csv}")
    if not tiles_h5_path.exists():
        raise FileNotFoundError(f"Tessellation H5 not found: {tiles_h5_path}")
    compat = compat or CompatConfig()

    df = pd.read_csv(annotations_csv)
    if "tile_index" not in df.columns:
        df = df.reset_index().rename(columns={"index": "tile_index"})

    h5 = read_tessellation_h5(tiles_h5_path)
    meta = {
        "tile_index": np.arange(len(h5["coords"]), dtype=np.int64),
        "x": h5["coords"][:, 0],
        "y": h5["coords"][:, 1],
    }
    if h5["level"] is not None:
        meta["level"] = h5["level"]
    df_coords = pd.DataFrame(meta)

    df_merged = df.merge(df_coords, on="tile_index", how="left")
    unmatched = df_merged["x"].isna()
    if unmatched.any():
        # annotations referencing tile indices absent from the H5 (e.g. a
        # re-tessellation changed the grid): drop them loudly instead of
        # crashing later on int(NaN), where the reference crashes
        get_logger().warning(
            "%d/%d annotation rows have no matching tile in the H5 "
            "(stale tile_index?) — dropped",
            int(unmatched.sum()), len(df_merged),
        )
        df_merged = df_merged[~unmatched].reset_index(drop=True)

    if patches_dir is None:
        pdir = Path(out_dir) / "patches"
        patches_dir = pdir if pdir.exists() else None
    if patches_dir is not None:
        patches_dir = Path(patches_dir)
        df_merged["png_path"] = [
            str(patches_dir / resolve_tile_png_name(int(r.x), int(r.y), int(r.tile_index), compat))
            for r in df_merged.itertuples()
        ]

    missing = [c for c in classes if c not in df_merged.columns]
    if missing:
        raise KeyError(f"Missing class score columns in annotations CSV: {missing}")
    df_merged["predicted_class"] = df_merged[classes].idxmax(axis=1)

    if add_tme_roi:
        # reference :195: every class is TME-eligible; only the seed set is
        # restricted to tumor classes
        tme_classes = list(classes) if compat.tme_classes_default_all else list(tumor_classes)
        tile_xy = df_merged[["x", "y"]].to_numpy(np.float32)
        is_tumor = df_merged["predicted_class"].isin(tumor_classes).to_numpy()
        is_eligible = df_merged["predicted_class"].isin(tme_classes).to_numpy()
        flags = tme_roi_flags(
            tile_xy,
            is_tumor,
            is_eligible,
            box_size=float(patch_size),
            margin=float(patch_size) * tme_margin_factor,
            corners="polygon8" if compat.polygonal_buffer_corners else "euclid",
            device=device,
        )
        df_merged["in_tme_roi"] = flags

    if save_merged:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        df_merged.to_csv(out_dir / f"{stem}_annotations_with_coords.csv", index=False)
    return df_merged


def run_spatial_join(
    out_dir: str | Path, stem: str, cfg: PipelineConfig, **overrides
) -> pd.DataFrame:
    """Config-driven wrapper used by the 8-step runner (``device`` among
    the overrides)."""
    out_dir = Path(out_dir)
    return load_annotations_with_coords(
        annotations_csv=overrides.pop("annotations_csv", out_dir / f"{stem}_annotations.csv"),
        tiles_h5_path=overrides.pop("tiles_h5_path", out_dir / f"{stem}.h5"),
        classes=list(cfg.classes),
        tumor_classes=list(cfg.tme_classes),
        out_dir=out_dir,
        stem=stem,
        patch_size=cfg.tme.roi_patch_size,
        tme_margin_factor=cfg.tme.buffer_factor,
        compat=cfg.compat,
        **overrides,
    )
