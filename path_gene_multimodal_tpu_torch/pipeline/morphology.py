"""Tissue/tumor boundary morphology + island analytics.

Counterpart of the JAX package's ``pipeline/morphology.py`` (the
reference's ``polygon_morphology.py`` and the burden-metrics script
``untitled.py``), with its five functions:

- ``tissue_boundary_mask``: HSV saturation > 0.04 → disk(6) closing →
  remove small objects / holes (5000 px), on the device; the small-object
  and hole removals label with K5 (``ops/cc.py::label_components_tiled``);
- ``mask_to_thumb_polygons``: labeled components (K5) → marching-squares
  exterior rings in thumbnail space;
- ``island_table_one_slide_level0``: one row per tumor/TIL/TLS island with
  area/perimeter/centroid/bbox + tissue area (the reference's exact column
  set);
- ``process_one_slide_make_csv_and_plot`` → ``<stem>_islands.csv`` +
  ``<stem>_boundaries.png``;
- ``write_basic_size_burden_metrics_txt``: the append-only per-slide TXT
  metric block.

The device work runs on ``device`` ("cuda" unless the caller asks for the
CPU, where K5 runs its plain version). The port uses neither cv2 nor
matplotlib: thumbnails and mask resizes go through ``io/slide.py``'s
cv2-equal resizes, and ``<stem>_boundaries.png`` is the thumbnail with the
tissue rings (black) and the tumor / TIL / TLS rings (``#d62728``,
``#2ca02c``, ``#1f77b4``) drawn as 1-px polylines, written as an RGB PNG by
``io/png.py``. It is not pixel-equal to the JAX package's
matplotlib figure (ROADMAP, Queue 3).
"""

from __future__ import annotations

from datetime import datetime
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np
import pandas as pd
import torch

from path_gene_multimodal_tpu_torch.core.artifacts import (
    load_geojson,
    polygon_ring_area_perimeter,
)
from path_gene_multimodal_tpu_torch.io.png import write_png
from path_gene_multimodal_tpu_torch.io.slide import SlideReader, resize_area, resize_nearest
from path_gene_multimodal_tpu_torch.ops import components as cc
from path_gene_multimodal_tpu_torch.ops import contours as ct
from path_gene_multimodal_tpu_torch.ops import morphology as morph
from path_gene_multimodal_tpu_torch.ops.cc import label_components_tiled
from path_gene_multimodal_tpu_torch.ops.masking import tissue_mask_hsv

GROUP_COLORS = {"tumor": "#d62728", "til": "#2ca02c", "tls": "#1f77b4"}


def _bucket(n: int) -> int:
    """Round up to a multiple of 256: the JAX package buckets the work
    shape so that one compiled program serves many slides; the port keeps
    the padding, which decides the CC tiles."""
    return (n + 255) // 256 * 256


def tissue_boundary_mask(
    thumb_rgb: np.ndarray,
    sat_threshold: float = 0.04,
    closing_radius: int = 6,
    min_size: int = 5000,
    max_work_dim: int = 1024,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Thumbnail-space tissue mask (polygon_morphology.py:100-153).

    Thumbnails larger than ``max_work_dim`` on the long side are processed
    at reduced resolution (closing radius and area thresholds scaled, with
    Python's ``round``) and upsampled back by nearest neighbour."""
    h, w = thumb_rgb.shape[:2]
    scale = max(h, w) / max_work_dim if max(h, w) > max_work_dim else 1.0
    work = np.asarray(thumb_rgb)
    if scale > 1.0:
        work = resize_area(work, int(w / scale), int(h / scale))
        closing_radius = max(int(round(closing_radius / scale)), 1)
        min_size = max(int(round(min_size / (scale * scale))), 1)
    wh, ww = work.shape[:2]
    ph, pw = _bucket(wh), _bucket(ww)
    work = np.pad(work, ((0, ph - wh), (0, pw - ww), (0, 0)))  # black = background
    mask = tissue_mask_hsv(torch.from_numpy(work).to(device), sat_threshold)
    mask = morph.binary_closing(mask, morph.disk(closing_radius))
    m = cc.remove_small_objects(mask, min_size)
    # hole fill with the padding as FOREGROUND: background padding would
    # join the right/bottom border pockets into one large background
    # component that never fills; the padding is cropped away after
    m[wh:, :] = True
    m[:, ww:] = True
    m = cc.remove_small_holes(m, min_size)
    mask_np = m[:wh, :ww].cpu().numpy()
    if scale > 1.0:
        mask_np = resize_nearest(mask_np.astype(np.uint8), w, h).astype(bool)
    return mask_np


def mask_to_thumb_polygons(mask: np.ndarray, max_work_dim: int = 1024,
                           device: str | torch.device = "cuda") -> list[np.ndarray]:
    """Per-component exterior rings (x, y) in thumbnail px, 4-connected
    components labeled by K5. Large masks are labeled at reduced resolution
    (ring coordinates scaled back)."""
    mask = np.asarray(mask)
    h, w = mask.shape
    scale = max(h, w) / max_work_dim if max(h, w) > max_work_dim else 1.0
    if scale > 1.0:
        small = resize_nearest(mask.astype(np.uint8), int(w / scale), int(h / scale)).astype(bool)
        return [r * scale for r in mask_to_thumb_polygons(small, max_work_dim, device)]
    mask_p = np.pad(mask.astype(bool), ((0, _bucket(h) - h), (0, _bucket(w) - w)))
    lbl = label_components_tiled(torch.from_numpy(mask_p).to(device), 1).cpu().numpy()
    lbl, n = cc.compact_labels(lbl[:h, :w])
    return [r[:, ::-1] for r in ct.component_rings(lbl, n)]  # (row, col) → (x, y)


def _ring_centroid(ring: np.ndarray) -> tuple[float, float]:
    """Polygon (area-weighted) centroid via the shoelace formula."""
    r = np.asarray(ring, np.float64)
    x, y = r[:, 0], r[:, 1]
    x2, y2 = np.roll(x, -1), np.roll(y, -1)
    cross = x * y2 - x2 * y
    a = cross.sum() / 2.0
    if abs(a) < 1e-12:
        return float(x.mean()), float(y.mean())
    cx = float(((x + x2) * cross).sum() / (6.0 * a))
    cy = float(((y + y2) * cross).sum() / (6.0 * a))
    return cx, cy


ISLAND_COLUMNS = [
    "slide_id", "type", "island_id", "area_px2", "perimeter_px",
    "centroid_x", "centroid_y", "bbox_xmin", "bbox_ymin", "bbox_xmax",
    "bbox_ymax", "tissue_area_px2",
]


def island_table_one_slide_level0(
    slide_id: str,
    geojson_path: str | Path,
    tumor_classes: Sequence[str],
    til_classes: Sequence[str],
    tls_classes: Sequence[str],
    tissue_area_px2: float,
) -> pd.DataFrame:
    """One row per tumor/til/tls island, level-0 coords
    (polygon_morphology.py:214-263, column parity)."""
    features = load_geojson(geojson_path)
    rows: list[dict[str, Any]] = []

    def add_rows(polys: list[Mapping[str, Any]], typ: str) -> None:
        for idx, f in enumerate(polys, start=1):
            ring = np.asarray(f["exterior"], np.float64)
            area, perim = polygon_ring_area_perimeter(ring)
            cx, cy = _ring_centroid(ring)
            rows.append({
                "slide_id": slide_id,
                "type": typ,
                "island_id": idx,
                "area_px2": float(f.get("area_px2") or area),
                "perimeter_px": float(f.get("perimeter_px") or perim),
                "centroid_x": cx,
                "centroid_y": cy,
                "bbox_xmin": float(ring[:, 0].min()),
                "bbox_ymin": float(ring[:, 1].min()),
                "bbox_xmax": float(ring[:, 0].max()),
                "bbox_ymax": float(ring[:, 1].max()),
                "tissue_area_px2": float(tissue_area_px2),
            })

    def by(classes):
        wanted = set(classes)
        return [f for f in features if f["class_name"] in wanted]

    add_rows(by(tumor_classes), "tumor")
    add_rows(by(til_classes), "til")
    add_rows(by(tls_classes), "tls")
    return pd.DataFrame(rows, columns=ISLAND_COLUMNS)


def draw_polyline(img: np.ndarray, pts: np.ndarray, color: tuple[int, int, int]) -> None:
    """Draw the 1-px polyline through ``pts`` (K, 2) (x, y) into the RGB
    uint8 ``img`` in place: each segment sampled at unit steps along its
    longer axis, rounded to pixel centres, clipped to the image."""
    p = np.asarray(pts, np.float64)
    if len(p) < 2:
        return
    d = p[1:] - p[:-1]
    steps = np.ceil(np.abs(d).max(axis=1)).astype(np.int64) + 1
    seg = np.repeat(np.arange(len(d)), steps)
    first = np.concatenate([[0], np.cumsum(steps)[:-1]])
    t = (np.arange(steps.sum()) - first[seg]) / np.maximum(steps[seg] - 1, 1)
    xy = np.rint(p[:-1][seg] + t[:, None] * d[seg]).astype(np.int64)
    h, w = img.shape[:2]
    ok = (xy[:, 0] >= 0) & (xy[:, 0] < w) & (xy[:, 1] >= 0) & (xy[:, 1] < h)
    img[xy[ok, 1], xy[ok, 0]] = color


def _hex_rgb(color: str) -> tuple[int, int, int]:
    return tuple(int(color[i : i + 2], 16) for i in (1, 3, 5))


def process_one_slide_make_csv_and_plot(
    slide: SlideReader,
    geojson_path: str | Path,
    out_dir: str | Path,
    stem: str,
    tumor_classes: Sequence[str],
    til_classes: Sequence[str],
    tls_classes: Sequence[str],
    thumb_size: tuple[int, int] = (2000, 2000),
    max_work_dim: int = 1024,
    device: str | torch.device = "cuda",
) -> pd.DataFrame:
    """→ ``<stem>_islands.csv`` + ``<stem>_boundaries.png``
    (polygon_morphology.py:267-359). ``max_work_dim`` goes to the tissue
    mask and its rings (the JAX package fixes it at 1024)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    thumb = slide.get_thumbnail(thumb_size)
    w0, _ = slide.level_dimensions[0]
    scale = w0 / thumb.shape[1]  # level-0 px per thumb px
    mask = tissue_boundary_mask(thumb, max_work_dim=max_work_dim, device=device)
    tissue_area_px2 = float(mask.sum()) * scale * scale

    df = island_table_one_slide_level0(
        stem, geojson_path, tumor_classes, til_classes, tls_classes, tissue_area_px2
    )
    df.to_csv(out_dir / f"{stem}_islands.csv", index=False)

    # boundaries plot: tissue rings + class island rings in thumbnail space
    img = np.array(thumb, dtype=np.uint8)
    for ring in mask_to_thumb_polygons(mask, max_work_dim, device):
        draw_polyline(img, ring, (0, 0, 0))
    group_of = {c: "tumor" for c in tumor_classes}
    group_of.update({c: "til" for c in til_classes})
    group_of.update({c: "tls" for c in tls_classes})
    for f in load_geojson(geojson_path):
        grp = group_of.get(f["class_name"])
        if grp is not None:
            draw_polyline(img, np.asarray(f["exterior"]) / scale, _hex_rgb(GROUP_COLORS[grp]))
    write_png(out_dir / f"{stem}_boundaries.png", img)
    return df


def write_basic_size_burden_metrics_txt(
    df_islands: pd.DataFrame,
    slide_id: str,
    out_txt_path: str | Path,
) -> Path:
    """Append the BASIC SIZE & BURDEN METRICS block (untitled.py:45-112;
    identical layout so downstream parsers keep working)."""
    tissue_area = (
        float(df_islands["tissue_area_px2"].iloc[0])
        if len(df_islands) and "tissue_area_px2" in df_islands.columns
        else 0.0
    )

    def sum_area(typ: str) -> float:
        if "type" not in df_islands.columns:
            return 0.0
        sub = df_islands[df_islands["type"] == typ]
        return float(sub["area_px2"].sum()) if not sub.empty else 0.0

    tumor_area = sum_area("tumor")
    til_area = sum_area("til")
    tls_area = sum_area("tls")
    immune_area = til_area + tls_area
    frac = lambda a: a / tissue_area if tissue_area > 0 else None  # noqa: E731
    tumor_frac, til_frac, tls_frac, immune_frac = map(
        frac, (tumor_area, til_area, tls_area, immune_area)
    )
    denom = tumor_area + immune_area
    immune_dom = immune_area / denom if denom > 0 else None

    out_txt_path = Path(out_txt_path)
    with open(out_txt_path, "a") as f:
        f.write("\n" + "=" * 60 + "\n")
        f.write("I. BASIC SIZE & BURDEN METRICS\n")
        f.write("=" * 60 + "\n")
        f.write(f"Slide ID: {slide_id}\n")
        f.write(f"Timestamp: {datetime.now().isoformat(timespec='seconds')}\n\n")
        f.write(f"Tissue area (px^2):        {tissue_area:.3e}\n")
        f.write(f"Tumor area (px^2):         {tumor_area:.3e}\n")
        f.write(f"TIL area (px^2):           {til_area:.3e}\n")
        f.write(f"TLS area (px^2):           {tls_area:.3e}\n")
        f.write(f"Immune area (px^2):        {immune_area:.3e}\n\n")
        if tumor_frac is not None:
            f.write(f"Tumor / tissue fraction:   {tumor_frac:.4f}\n")
        if til_frac is not None:
            f.write(f"TIL / tissue fraction:     {til_frac:.4f}\n")
        if tls_frac is not None:
            f.write(f"TLS / tissue fraction:     {tls_frac:.4f}\n")
        if immune_frac is not None:
            f.write(f"Immune / tissue fraction:  {immune_frac:.4f}\n")
        f.write("\n")
        if immune_dom is not None:
            f.write(
                "Immune dominance index\n"
                f"(immune / (tumor + immune)): {immune_dom:.4f}\n"
            )
        else:
            f.write("Immune dominance index: NA\n")
        f.write("\n")
    return out_txt_path
