"""Artifacts: a copy of the JAX package's ``core/artifacts.py`` without
``tiles_table`` / ``export_tiles_csv``: the tessellation H5
(``write_tessellation_h5``, ``read_tessellation_h5`` with the reference's
five schema variants and column rules), ``infer_tile_size_from_attrs``,
``savez_fast``, the features H5, the GeoJSON helpers, the annotations-CSV
contract, ``write_nuclei_table``, ``json_safe`` and
``sanitize_for_filename``. The H5 files go through the port's own HDF5
subset (``io/hdf5.py``), which writes h5py's default layout and reads it
back; the port needs no h5py."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterable, Mapping

import numpy as np
import pandas as pd

from path_gene_multimodal_tpu_torch.io import hdf5

#: dataset-name probe order for tile coordinates, mirroring the reference's
#: multi-schema fallback chain (load_annotation_with_coordinates.py:123-129).
_COORD_KEYS = ("coords", "locations", "tiles/coords")
_XY_KEYS = (("x", "y"), ("tiles/x", "tiles/y"))


def write_tessellation_h5(
    path: str | Path,
    coords: np.ndarray,
    *,
    tile_size: int,
    level: int = 0,
    mpp: float | None = None,
    downsample: float = 1.0,
    extra_attrs: Mapping[str, Any] | None = None,
) -> Path:
    """Write canonical tessellation H5: ``coords`` (N, 2) int64 level-0
    top-left pixel coordinates, plus sizing attrs (tiling_info.py:39-54)."""
    coords = np.asarray(coords, dtype=np.int64).reshape(-1, 2)
    ds_attrs: dict[str, Any] = {"tile_size": tile_size, "patch_size": tile_size,
                                "level": level, "downsample": downsample}
    root: dict[str, Any] = {"tile_size": tile_size, "patch_size": tile_size, "level": level}
    if mpp is not None:
        ds_attrs["mpp"] = mpp
        root["mpp"] = mpp
    root.update(extra_attrs or {})
    return hdf5.write_h5(path, {"coords": (coords, ds_attrs)}, root)


def _coord_column_names(arr: np.ndarray, attrs: Mapping[str, Any]) -> list[str]:
    """Column names for a 2-D coords array — the reference's rule
    (tiling_info.py:10-27): an explicit ``columns`` attr wins; otherwise
    width-based defaults (2→x,y; 3→x,y,level; 4→x,y,w,h; else col{i})."""
    raw_cols = attrs.get("columns")
    if raw_cols is not None:
        cols = [
            c.decode() if isinstance(c, bytes) else str(c)
            for c in np.asarray(raw_cols).reshape(-1)
        ]
        if len(cols) == arr.shape[1]:
            return cols
    n = arr.shape[1]
    if n == 2:
        return ["x", "y"]
    if n == 3:
        return ["x", "y", "level"]
    if n == 4:
        return ["x", "y", "w", "h"]
    return [f"col{i}" for i in range(n)]


def read_tessellation_h5(path: str | Path) -> dict[str, Any]:
    """Read tile coordinates from any of the five schema variants the
    reference accepts. Returns ``{"coords": (N,2) int64, "level": array|None,
    "attrs": dict, "raw_coords": (N,C) array, "columns": list[str]}``.

    Probe order (load_annotation_with_coordinates.py:122-165):
    1. ``coords`` / ``locations`` / ``tiles/coords`` datasets of shape (N, 2);
    2. paired 1-D ``x``,``y`` or ``tiles/x``,``tiles/y`` datasets;
    3. any dataset whose name ends in ``coords`` with shape (N, 2).

    Wider datasets follow the reference's column semantics
    (tiling_info.py:10-27): width 3 carries a per-tile pyramid ``level``
    column, width 4 is ``x,y,w,h`` (NOT level), and an explicit ``columns``
    dataset attr overrides both.
    """
    path = Path(path)
    with hdf5.File(path) as f:
        coords = None
        src_attrs: dict[str, Any] = dict(f.attrs)

        for key in _COORD_KEYS:
            if key in f:
                ds = f[key]
                coords = np.asarray(ds[...])
                src_attrs.update(dict(ds.attrs))
                break
        if coords is None:
            for xk, yk in _XY_KEYS:
                if xk in f and yk in f:
                    x = np.asarray(f[xk][...]).reshape(-1)
                    y = np.asarray(f[yk][...]).reshape(-1)
                    coords = np.stack([x, y], axis=1)
                    src_attrs.update(dict(f[xk].attrs))
                    break
        if coords is None:
            # wildcard fallback: first dataset whose name ends in "coords"
            found: list[str] = []

            def _visit(name: str, obj: Any) -> None:
                if isinstance(obj, hdf5.Dataset) and name.endswith("coords"):
                    found.append(name)

            f.visititems(_visit)
            if found:
                ds = f[found[0]]
                coords = np.asarray(ds[...])
                src_attrs.update(dict(ds.attrs))
        if coords is None:
            raise ValueError(
                f"{path}: no tile-coordinate dataset found "
                f"(tried {_COORD_KEYS}, x/y pairs, *coords)"
            )

        coords = np.asarray(coords)
        if coords.ndim == 1 and coords.size % 2 == 0:
            # 1-D flattened pairs (tiling_info.py:19 fallback)
            coords = coords.reshape(-1, 2)
        if coords.ndim != 2 or coords.shape[1] < 2:
            raise ValueError(f"{path}: coords has shape {coords.shape}, expected (N, 2)")

        columns = _coord_column_names(coords, src_attrs)
        xi = columns.index("x") if "x" in columns else 0
        yi = columns.index("y") if "y" in columns else 1
        xy = np.stack([coords[:, xi], coords[:, yi]], axis=1)

        level = None
        if "level" in columns:
            level = coords[:, columns.index("level")].astype(np.int64)
        elif "level" in f:
            level = np.asarray(f["level"][...]).reshape(-1).astype(np.int64)

        return {
            "coords": xy.astype(np.int64),
            "level": level,
            "attrs": src_attrs,
            "raw_coords": coords,
            "columns": columns,
        }


def infer_tile_size_from_attrs(attrs: Mapping[str, Any]) -> int | None:
    """``tile_size``/``patch_size``/``size`` attr probe (tiling_info.py:39)."""
    for key in ("tile_size", "patch_size", "size"):
        if key in attrs:
            try:
                return int(np.asarray(attrs[key]).reshape(-1)[0])
            except (TypeError, ValueError):
                continue
    return None


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
    features = np.asarray(features)
    n = features.shape[0]
    idx = np.arange(n, dtype=np.int64) if tile_index is None else np.asarray(tile_index)
    return hdf5.write_h5(path, {"features": features, "tile_index": idx.astype(np.int64)},
                         {"model_type": model_type, "dim": features.shape[-1]})


def read_features_h5(path: str | Path) -> dict[str, Any]:
    with hdf5.File(path) as f:
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


def json_safe(obj: Any) -> Any:
    """Recursively convert numpy/Path objects to JSON-serializable Python
    (reference main.py:33-55)."""
    if isinstance(obj, Mapping):
        return {str(k): json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return json_safe(obj.tolist())
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, Path):
        return str(obj)
    return obj


def sanitize_for_filename(name: str, max_len: int = 80) -> str:
    """Class label → safe filename fragment (class names contain '/')."""
    out = "".join(c if c.isalnum() or c in "-_ " else "_" for c in name)
    out = "_".join(out.split())
    return out[:max_len] or "class"
