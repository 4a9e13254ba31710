"""Tabular artifacts of the nuclei stage: a copy of the annotations-CSV
contract and ``write_nuclei_table`` from the JAX package's
``core/artifacts.py`` (lines 402-448)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pandas as pd

#: required columns of the annotations CSV (checked by the reference's
#: aggregated_hovernet_run.py:41-44).
ANNOTATION_REQUIRED_COLUMNS = ("tile_index", "x", "y", "predicted_class", "in_tme_roi")


def write_annotations_csv(path: str | Path, df: pd.DataFrame) -> Path:
    missing = [c for c in ANNOTATION_REQUIRED_COLUMNS if c not in df.columns]
    if missing:
        raise ValueError(f"annotations frame missing required columns: {missing}")
    path = Path(path)
    df.to_csv(path, index=False)
    return path


def read_annotations_csv(path: str | Path) -> pd.DataFrame:
    df = pd.read_csv(path)
    missing = [c for c in ANNOTATION_REQUIRED_COLUMNS if c not in df.columns]
    if missing:
        raise ValueError(f"{path} missing required columns: {missing}")
    return df


def write_nuclei_table(path_base: str | Path, df: pd.DataFrame) -> tuple[Path, Path]:
    """Write ``<base>.csv`` + ``<base>.parquet`` (aggregated_hovernet_run.py:401-402).

    List-valued columns (bounding_box, centroid, polygon, wsi_polygon) are
    JSON-encoded in the CSV and kept as lists in parquet.
    """
    base = Path(path_base)
    # NOT with_suffix: real TCGA stems contain dots ("TCGA-...-DX1.d4ff32cd")
    # and with_suffix would truncate at the first dot, mangling the filename.
    csv_path = base.parent / (base.name + ".csv")
    pq_path = base.parent / (base.name + ".parquet")
    csv_df = df.copy()
    for col in csv_df.columns:
        if csv_df[col].map(lambda v: isinstance(v, (list, tuple, np.ndarray))).any():
            csv_df[col] = csv_df[col].map(
                lambda v: json.dumps(np.asarray(v).tolist())
                if isinstance(v, (list, tuple, np.ndarray))
                else v
            )
    csv_df.to_csv(csv_path, index=False)
    pq_df = df.copy()
    for col in pq_df.columns:
        pq_df[col] = pq_df[col].map(
            lambda v: np.asarray(v).tolist() if isinstance(v, np.ndarray) else v
        )
    pq_df.to_parquet(pq_path, index=False)
    return csv_path, pq_path
