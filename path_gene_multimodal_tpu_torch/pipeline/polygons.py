"""Steps 6-7 of 8 — tile predictions → smoothed class masks → polygons →
GeoJSON.

A copy of the JAX package's ``pipeline/polygons.py``, the reference's
``build_polygons_for_all_classes`` + ``export_geojson``
(``create_and_overlay_polygon_from_prediction.py:309-397``):

1. tiles → grid, 1 tile = 1 grid px (``tiles_to_grid`` ``:79-137``). The
   reference maps tiles by the RANK of their unique x/y values (gaps in the
   grid collapse); that quirk is preserved by default
   (``compat.rank_compressed_grid``) with a corrected dense mapping
   available.
2. per-class binary masks, closing+opening with disk(smooth_radius), optional
   gaussian blur > 0.5, small-object removal (``smooth_mask`` ``:160-179``)
   — all K classes in one batched call on the device; the small-object
   removal labels each class with K5 (``ops/cc.py::label_components_tiled``:
   its kernel on the card, its plain version on the CPU), one call a class.
3. overlap resolution: prob-argmax or priority order (``:186-218``).
4. per-class connected components (4-conn, the plain labeling on the host:
   the grid is one pixel a tile) → exterior marching-squares ring
   per component → slide-px scaling → Douglas-Peucker simplify
   (tol = tile * simplify_frac) → area filter (``:225-302``).
5. GeoJSON FeatureCollection with {class, area_px2, perimeter_px}.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np
import pandas as pd
import torch

from path_gene_multimodal_tpu_torch.config import PipelineConfig
from path_gene_multimodal_tpu_torch.core.artifacts import export_geojson as _write_geojson
from path_gene_multimodal_tpu_torch.core.artifacts import polygon_ring_area_perimeter
from path_gene_multimodal_tpu_torch.ops import components as cc
from path_gene_multimodal_tpu_torch.ops import contours as ct
from path_gene_multimodal_tpu_torch.ops import morphology as morph
from path_gene_multimodal_tpu_torch.ops.gridops import infer_tile_size


def tiles_to_grid(
    df: pd.DataFrame,
    classes: Sequence[str],
    tile_w: int | None = None,
    tile_h: int | None = None,
    rank_compressed: bool = True,
) -> dict[str, Any]:
    """Build the label grid. Returns dict with ``label_grid`` (H, W) int16
    (-1 empty), ``prob_grids`` (K, H, W) from the class score columns when
    present, ``x_coords``/``y_coords``, ``tile_w``/``tile_h``."""
    for col in ("x", "y", "predicted_class"):
        if col not in df.columns:
            raise KeyError(f"tiles_to_grid requires column '{col}'")
    x_vals = np.sort(df["x"].unique())
    y_vals = np.sort(df["y"].unique())
    tile_w = tile_w or infer_tile_size(np.stack([x_vals, np.zeros_like(x_vals)], 1), 256)
    tile_h = tile_h or infer_tile_size(np.stack([y_vals, np.zeros_like(y_vals)], 1), 256)

    if rank_compressed:
        # reference behavior: grid index = rank of the unique coordinate
        x_to_ix = {v: i for i, v in enumerate(x_vals)}
        y_to_iy = {v: i for i, v in enumerate(y_vals)}
        gw, gh = len(x_vals), len(y_vals)
        # explicit int64: an empty frame maps to an object-dtype array,
        # which numpy rejects as an index
        ix = df["x"].map(x_to_ix).to_numpy(np.int64)
        iy = df["y"].map(y_to_iy).to_numpy(np.int64)
    elif len(x_vals) == 0:  # empty frame: 0×0 grid (rank path's behavior)
        ix = iy = np.zeros(0, np.int64)
        gw = gh = 0
    else:
        x0, y0 = int(x_vals[0]), int(y_vals[0])
        ix = ((df["x"].to_numpy() - x0) // tile_w).astype(np.int64)
        iy = ((df["y"].to_numpy() - y0) // tile_h).astype(np.int64)
        gw, gh = int(ix.max()) + 1, int(iy.max()) + 1

    class_to_idx = {c: i for i, c in enumerate(classes)}
    label_grid = np.full((gh, gw), -1, np.int16)
    labels = df["predicted_class"].map(class_to_idx).fillna(-1).to_numpy(np.int16)
    label_grid[iy, ix] = labels

    prob_grids = None
    score_cols = [c for c in classes if c in df.columns]
    if len(score_cols) == len(classes):
        prob_grids = np.zeros((len(classes), gh, gw), np.float32)
        for k, c in enumerate(classes):
            prob_grids[k, iy, ix] = df[c].to_numpy(np.float32)

    return {
        "label_grid": label_grid,
        "prob_grids": prob_grids,
        "x_coords": x_vals,
        "y_coords": y_vals,
        "tile_w": int(tile_w),
        "tile_h": int(tile_h),
        "rank_compressed": rank_compressed,
    }


def smooth_and_resolve(
    grid: Mapping[str, Any],
    num_classes: int,
    smooth_radius_tiles: float = 1.0,
    blur_sigma: float | None = None,
    area_min_tiles: int = 0,
    overlap_mode: str = "prob",
    priorities: Sequence[int] | None = None,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Batched smoothing + exclusivity on ``device``. Returns (K, H, W) bool."""
    label_grid = torch.as_tensor(np.asarray(grid["label_grid"]), device=device)
    masks = torch.stack([label_grid == k for k in range(num_classes)], dim=0)  # (K, H, W)
    radius = int(round(smooth_radius_tiles))
    if radius > 0:
        se = morph.disk(radius)
        smoothed = morph.binary_opening(morph.binary_closing(masks, se), se)
    else:
        # radius 0 = smoothing OFF (a radius-1 opening would erase every
        # isolated single-tile class region)
        smoothed = masks
    if blur_sigma is not None and blur_sigma > 0:
        smoothed = morph.gaussian_blur(smoothed.float(), blur_sigma) > 0.5
    if area_min_tiles and area_min_tiles > 0:
        # each plane in its own allocation: K5 takes a 32-byte aligned mask,
        # which a plane's view into the stack is not in general
        smoothed = torch.stack([cc.remove_small_objects(smoothed[k].clone(), area_min_tiles)
                                for k in range(num_classes)], dim=0)

    if overlap_mode == "prob" and grid.get("prob_grids") is not None:
        probs = torch.as_tensor(np.asarray(grid["prob_grids"]), device=device)
        probs = torch.where(smoothed, probs, float("-inf"))
        assign = torch.argmax(probs, dim=0)
        any_on = smoothed.any(dim=0)
        resolved = torch.stack([(assign == k) & any_on for k in range(num_classes)], dim=0)
    else:
        order = list(priorities) if priorities is not None else list(range(num_classes))
        taken = torch.zeros(smoothed.shape[1:], dtype=torch.bool, device=smoothed.device)
        planes: list = [None] * num_classes
        for k in order:
            planes[k] = smoothed[k] & ~taken
            taken = taken | smoothed[k]
        resolved = torch.stack(planes, dim=0)
    return resolved.cpu().numpy()


def mask_to_features(
    mask: np.ndarray,
    class_name: str,
    grid: Mapping[str, Any],
    simplify_frac: float = 0.2,
    min_polygon_area_px: float = 0,
) -> list[dict[str, Any]]:
    """One class plane → tagged polygon features in level-0 slide px."""
    tile_w, tile_h = grid["tile_w"], grid["tile_h"]
    x0 = float(grid["x_coords"][0]) if len(grid["x_coords"]) else 0.0
    y0 = float(grid["y_coords"][0]) if len(grid["y_coords"]) else 0.0
    tol_grid = simplify_frac  # tol in slide px = tile * frac → grid units = frac
    lbl = cc.label_components(torch.from_numpy(np.asarray(mask, bool))[None])[0]
    lbl, n = cc.compact_labels(lbl.numpy())
    features: list[dict[str, Any]] = []
    for ring0 in ct.component_rings(lbl, n):
        ring = ct.douglas_peucker(ring0, tol_grid, closed=True)
        if len(ring) < 3:
            continue
        # (row, col) grid units → slide px
        gx = ring[:, 1]
        gy = ring[:, 0]
        # slide-px mapping X = x0 + index*tile (reference :246-248); under
        # rank compression "index" is the coordinate rank — same formula,
        # its geometric distortion for gappy grids is the preserved quirk
        X = x0 + gx * tile_w
        Y = y0 + gy * tile_h
        ext = np.stack([X, Y], axis=1)
        area, perim = polygon_ring_area_perimeter(ext)
        if min_polygon_area_px and area < min_polygon_area_px:
            continue
        features.append(
            {
                "class_name": class_name,
                "exterior": ext,
                "area_px2": area,
                "perimeter_px": perim,
            }
        )
    return features


def build_polygons_for_all_classes(
    df: pd.DataFrame,
    classes: Sequence[str],
    cfg: PipelineConfig,
    tile_w: int | None = None,
    tile_h: int | None = None,
    device: str | torch.device = "cuda",
) -> list[dict[str, Any]]:
    p = cfg.polygon
    grid = tiles_to_grid(
        df, classes, tile_w=tile_w, tile_h=tile_h,
        rank_compressed=cfg.compat.rank_compressed_grid,
    )
    resolved = smooth_and_resolve(
        grid,
        num_classes=len(classes),
        smooth_radius_tiles=p.smooth_radius_tiles,
        blur_sigma=p.blur_sigma,
        area_min_tiles=p.area_min_tiles,
        overlap_mode=p.overlap_mode,
        device=device,
    )
    features: list[dict[str, Any]] = []
    for k, c in enumerate(classes):
        if not resolved[k].any():
            continue
        features.extend(
            mask_to_features(
                resolved[k], c, grid,
                simplify_frac=p.simplify_frac,
                min_polygon_area_px=p.min_polygon_area_px,
            )
        )
    return features


def export_geojson(
    features: list[dict[str, Any]], out_dir: str | Path, stem: str
) -> Path:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = _write_geojson(out_dir / f"{stem}.geojson", features)
    if not path.exists():
        raise RuntimeError(f"geojson export failed to produce {path}")
    return path
