"""Artifacts: a copy of ``savez_fast`` (line 175), the features H5
(``write_features_h5``, ``read_features_h5``, lines 266-295), the GeoJSON
helpers (``polygon_ring_area_perimeter``, ``export_geojson``,
``load_geojson``), the annotations-CSV contract and ``write_nuclei_table``
from the JAX package's ``core/artifacts.py`` (lines 301-397, 402-448).
``h5py`` is imported by the functions that need it, so that this module
imports without it."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterable, Mapping

import numpy as np
import pandas as pd


def savez_fast(path: str | Path, /, compresslevel: int = 1, **arrays: Any) -> Path:
    """``np.load``-compatible ``.npz`` writer with fast deflate.

    ``np.savez_compressed`` pins zlib level 6 with no override; at WSI
    scale the gigabyte-class arrays (50M-edge cell graphs) spend longer in
    the compressor than in the maths that produced them. Level 1 trades a
    somewhat larger file for a faster write. Streams each array straight into the zip member (no BytesIO staging)."""
    import zipfile

    from numpy.lib import format as npformat

    if not isinstance(compresslevel, int):
        # an array keyword literally named "compresslevel" binds to this
        # parameter (np.savez has the same hazard for "file") — fail loudly
        # instead of silently dropping the member from the npz
        raise TypeError(
            "'compresslevel' is a reserved keyword of savez_fast (int zip "
            "level); an array may not use that name"
        )
    path = Path(path)
    with zipfile.ZipFile(
        path, "w", zipfile.ZIP_DEFLATED, compresslevel=compresslevel
    ) as zf:
        for name, arr in arrays.items():
            with zf.open(f"{name}.npy", "w", force_zip64=True) as fh:
                npformat.write_array(fh, np.ascontiguousarray(np.asarray(arr)))
    return path


def write_features_h5(
    path: str | Path,
    features: np.ndarray,
    *,
    tile_index: np.ndarray | None = None,
    model_type: str = "CLIP",
) -> Path:
    """``<slide>_features.h5``: ``features`` (N, D), ``tile_index`` (N,)
    int64, attrs ``model_type`` and ``dim``."""
    import h5py

    path = Path(path)
    features = np.asarray(features)
    with h5py.File(path, "w") as f:
        f.create_dataset("features", data=features)
        n = features.shape[0]
        idx = np.arange(n, dtype=np.int64) if tile_index is None else np.asarray(tile_index)
        f.create_dataset("tile_index", data=idx.astype(np.int64))
        f.attrs["model_type"] = model_type
        f.attrs["dim"] = features.shape[-1]
    return path


def read_features_h5(path: str | Path) -> dict[str, Any]:
    import h5py

    with h5py.File(path, "r") as f:
        return {
            "features": np.asarray(f["features"][...]),
            "tile_index": np.asarray(f["tile_index"][...])
            if "tile_index" in f
            else None,
            "attrs": dict(f.attrs),
        }


def polygon_ring_area_perimeter(ring: np.ndarray) -> tuple[float, float]:
    """Shoelace area (absolute) and perimeter of a closed ring (K, 2)."""
    ring = np.asarray(ring, dtype=np.float64)
    if len(ring) < 3:
        return 0.0, 0.0
    x, y = ring[:, 0], ring[:, 1]
    x2, y2 = np.roll(x, -1), np.roll(y, -1)
    area = 0.5 * abs(np.sum(x * y2 - x2 * y))
    perimeter = float(np.sum(np.hypot(x2 - x, y2 - y)))
    return float(area), perimeter


def export_geojson(path: str | Path, polygons: Iterable[Mapping[str, Any]]) -> Path:
    """Write a FeatureCollection. Each input mapping needs ``class_name`` and
    ``exterior`` (K, 2 level-0 px); optional ``holes`` (list of rings),
    ``area_px2``, ``perimeter_px`` (computed if absent; shapely semantics:
    holes subtract from the area and add to the perimeter). Rings of fewer
    than 3 points are dropped. Schema: the reference's
    create_and_overlay_polygon_from_prediction.py:359-397."""
    features = []
    for poly in polygons:
        ext = np.asarray(poly["exterior"], dtype=np.float64)
        if len(ext) < 3:
            continue
        rings = [ext] + [
            h2 for h in poly.get("holes", [])
            if len(h2 := np.asarray(h, dtype=np.float64)) >= 3
        ]
        area = poly.get("area_px2")
        perim = poly.get("perimeter_px")
        if area is None:
            area = polygon_ring_area_perimeter(ext)[0]
            for hole in rings[1:]:
                area -= polygon_ring_area_perimeter(hole)[0]
        if perim is None:
            perim = polygon_ring_area_perimeter(ext)[1]
            for hole in rings[1:]:
                perim += polygon_ring_area_perimeter(hole)[1]
        coords = []
        for ring in rings:
            ring_closed = ring
            if not np.array_equal(ring[0], ring[-1]):
                ring_closed = np.concatenate([ring, ring[:1]], axis=0)
            coords.append([[float(x), float(y)] for x, y in ring_closed])
        features.append(
            {
                "type": "Feature",
                "properties": {
                    "class": str(poly["class_name"]),
                    "area_px2": float(area),
                    "perimeter_px": float(perim),
                },
                "geometry": {"type": "Polygon", "coordinates": coords},
            }
        )
    path = Path(path)
    path.write_text(json.dumps({"type": "FeatureCollection", "features": features}))
    return path


def load_geojson(path: str | Path) -> list[dict[str, Any]]:
    """Load a FeatureCollection back into ``[{class_name, exterior, holes,
    area_px2, perimeter_px}]`` with numpy rings."""
    fc = json.loads(Path(path).read_text())
    out = []
    for feat in fc.get("features", []):
        geom = feat.get("geometry") or {}
        if geom.get("type") != "Polygon":
            continue
        rings = [np.asarray(r, dtype=np.float64) for r in geom.get("coordinates", [])]
        if not rings:
            continue
        props = feat.get("properties") or {}
        out.append(
            {
                "class_name": props.get("class"),
                "exterior": rings[0],
                "holes": rings[1:],
                "area_px2": props.get("area_px2"),
                "perimeter_px": props.get("perimeter_px"),
            }
        )
    return out


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
