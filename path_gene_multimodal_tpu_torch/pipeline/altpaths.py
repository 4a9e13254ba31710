"""Alternative polygon-extraction paths.

A copy of the JAX package's ``pipeline/altpaths.py``: the reference's two
standalone variants of the tiles → polygons flow, on the shared
mask-domain ops (the reference used shapely buffers for one and cv2
raster morphology for the other):

- ``tumor_polygon_from_patches`` (C16, ``extract_jeojson_file.py:23-68``):
  union of tile boxes → buffer(+r)/buffer(−r) smoothing → simplify →
  min-area filter → LARGEST polygon. Mask-domain equivalent: rasterize
  tiles at sub-tile resolution, morphological closing with a disk of the
  buffer radius, largest component's contour.
- ``mask_contour_from_tiles`` (C17, ``polygon_and_preview.py:10-79``):
  level-0 → ≤``max_raster`` raster, filled tile rectangles, ellipse
  CLOSE/OPEN kernels sized by a patch fraction, component area filter,
  contours → level-0 polygons; plus the RGBA polygon-on-thumbnail
  compositor (``:82-110``).

The rasters are filled on the host, as in JAX, and moved to ``device``
(the card unless the caller passes ``"cpu"``) for the closing and opening
(``F.conv2d`` counts, run under ``exact_f32``), the small-object removal
and the labelling; the labels come back for ring tracing. Every labelling
here is K5 (``ops/cc.py::label_components_tiled``: its kernel on a CUDA
tensor, its plain version on a CPU tensor; ``remove_small_objects`` labels
with it too), where the JAX package labels with its XLA fixpoint (at most
257 relaxations over the whole raster). The two agree wherever both
converge; on a raster whose components need more relaxations than that,
K5 (128 a tile and round, 64 rounds) still converges where XLA's stops
short.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from path_gene_multimodal_tpu_torch.core.artifacts import (
    export_geojson,
    polygon_ring_area_perimeter,
)
from path_gene_multimodal_tpu_torch.ops import components as cc
from path_gene_multimodal_tpu_torch.ops import contours as ct
from path_gene_multimodal_tpu_torch.ops import morphology as morph
from path_gene_multimodal_tpu_torch.ops.cc import label_components_tiled
from path_gene_multimodal_tpu_torch.ops.cuda import exact_f32


def _largest_component(mask: torch.Tensor) -> np.ndarray:
    lbl, n = cc.compact_labels(label_components_tiled(mask, 1).cpu().numpy())
    if n == 0:
        return np.zeros(tuple(mask.shape), bool)
    sizes = np.bincount(lbl.reshape(-1))[1:]
    return lbl == (int(np.argmax(sizes)) + 1)


def tumor_polygon_from_patches(
    coords: np.ndarray,
    patch_size: int,
    smooth_radius_px: float | None = None,
    simplify_px: float | None = None,
    min_area_px2: float | None = None,
    raster_scale: int = 4,
    device: str | torch.device = "cuda",
) -> np.ndarray | None:
    """Largest smoothed tumor polygon from patch top-left coords
    (extract_jeojson_file.py semantics). ``raster_scale`` = raster px per
    patch edge (sub-tile resolution so the buffer radius is honored).
    Returns (K, 2) level-0 ring or None."""
    coords = np.asarray(coords, np.int64)
    if len(coords) == 0:
        return None
    smooth_radius_px = smooth_radius_px if smooth_radius_px is not None else patch_size * 0.5
    simplify_px = simplify_px if simplify_px is not None else patch_size * 0.1
    min_area_px2 = min_area_px2 if min_area_px2 is not None else patch_size**2

    px_per_unit = patch_size / raster_scale  # level-0 px per raster px
    x0, y0 = coords[:, 0].min(), coords[:, 1].min()
    gx = ((coords[:, 0] - x0) / px_per_unit).astype(np.int64)
    gy = ((coords[:, 1] - y0) / px_per_unit).astype(np.int64)
    gw = int(gx.max()) + raster_scale
    gh = int(gy.max()) + raster_scale
    # the canvas bucketed to 256-multiples (zero pad = background), as JAX
    ph, pw = ((gh + 255) // 256) * 256, ((gw + 255) // 256) * 256
    mask = np.zeros((ph, pw), bool)
    for xi, yi in zip(gx, gy):
        mask[yi : yi + raster_scale, xi : xi + raster_scale] = True

    r = max(1, int(round(smooth_radius_px / px_per_unit)))
    # buffer(+r).buffer(-r) = morphological closing (zero-extended borders,
    # identical on the padded canvas: closing cannot create foreground in
    # an all-background band wider than the kernel)
    with exact_f32():
        smoothed = morph.binary_closing(torch.from_numpy(mask).to(device), morph.disk(r))
    comp = _largest_component(smoothed)[:gh, :gw]
    if not comp.any():
        return None
    ring = ct.exterior_ring(comp)
    if ring is None or len(ring) < 3:
        return None
    ring = ct.douglas_peucker(ring, simplify_px / px_per_unit, closed=True)
    out = np.stack(
        [ring[:, 1] * px_per_unit + x0, ring[:, 0] * px_per_unit + y0], axis=1
    )
    area, _ = polygon_ring_area_perimeter(out)
    if area < min_area_px2:
        return None
    return out


def tumor_geojson_for_slides(
    per_slide_coords: dict[str, np.ndarray],
    patch_size: int,
    out_dir: str | Path,
    **kw: Any,
) -> dict[str, Path]:
    """Per-slide grouping + GeoJSON save (extract_jeojson_file.py:77-119).
    ``kw`` goes to ``tumor_polygon_from_patches`` (``device`` included)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    outputs: dict[str, Path] = {}
    for stem, coords in per_slide_coords.items():
        ring = tumor_polygon_from_patches(coords, patch_size, **kw)
        if ring is None:
            continue
        outputs[stem] = export_geojson(
            out_dir / f"{stem}_tumor.geojson",
            [{"class_name": "tumor", "exterior": ring}],
        )
    return outputs


def raster_geometry(slide_dims: tuple[int, int], patch_size: int,
                    max_raster: int = 6000) -> dict[str, Any]:
    """``mask_contour_from_tiles``'s raster: the level-0 px per raster px
    (``scale``), the raster (``rw``, ``rh``), the 256-bucketed canvas
    (``pw``, ``ph``) and a patch's side in raster px (``patch_r``)."""
    w0, h0 = slide_dims
    scale = max(w0, h0) / max_raster if max(w0, h0) > max_raster else 1.0
    # the patch footprint capped at 16 raster px, as JAX (a dense conv does
    # not take the reference's 100+-px ellipse kernels)
    scale = max(scale, patch_size / 16.0)
    rw, rh = int(np.ceil(w0 / scale)), int(np.ceil(h0 / scale))
    return {"scale": scale, "rw": rw, "rh": rh,
            "pw": ((rw + 255) // 256) * 256, "ph": ((rh + 255) // 256) * 256,
            "patch_r": max(int(round(patch_size / scale)), 1)}


def mask_contour_from_tiles(
    coords: np.ndarray,
    patch_size: int,
    slide_dims: tuple[int, int],
    max_raster: int = 6000,
    close_frac: float = 1.5,
    open_frac: float = 0.5,
    min_area_frac: float = 1.0,
    device: str | torch.device = "cuda",
) -> list[np.ndarray]:
    """Raster-contour path (polygon_and_preview.py:10-79): tiles → ≤max_raster
    raster fill → ellipse close/open (kernels = frac × patch in raster px) →
    component area filter (≥ min_area_frac patch areas) → level-0 rings."""
    coords = np.asarray(coords, np.int64)
    if len(coords) == 0:
        return []
    g = raster_geometry(slide_dims, patch_size, max_raster)
    scale, rw, rh, patch_r = g["scale"], g["rw"], g["rh"], g["patch_r"]
    mask = np.zeros((g["ph"], g["pw"]), bool)
    for x, y in coords:
        xi, yi = int(x / scale), int(y / scale)
        mask[yi : yi + patch_r, xi : xi + patch_r] = True

    close_k = morph.ellipse_kernel(
        max(int(patch_r * close_frac) | 1, 3), max(int(patch_r * close_frac) | 1, 3)
    )
    open_k = morph.ellipse_kernel(
        max(int(patch_r * open_frac) | 1, 3), max(int(patch_r * open_frac) | 1, 3)
    )
    with exact_f32():
        m = morph.binary_closing(torch.from_numpy(mask).to(device), close_k)
        m = morph.binary_opening(m, open_k)
    m = cc.remove_small_objects(m, int(min_area_frac * patch_r * patch_r))
    lbl, n = cc.compact_labels(label_components_tiled(m, 1)[:rh, :rw].cpu().numpy())
    return [
        np.stack([r[:, 1] * scale, r[:, 0] * scale], axis=1)
        for r in ct.component_rings(lbl, n)
    ]


def composite_polygons_on_thumbnail(
    thumb: np.ndarray,
    rings_level0: Sequence[np.ndarray],
    scale: float,
    fill_rgba: tuple[int, int, int, int] = (220, 40, 40, 90),
    outline_rgba: tuple[int, int, int, int] = (220, 40, 40, 255),
) -> np.ndarray:
    """RGBA polygon compositor (polygon_and_preview.py:82-110; PIL-based)."""
    from PIL import Image, ImageDraw

    base = Image.fromarray(thumb).convert("RGBA")
    layer = Image.new("RGBA", base.size, (0, 0, 0, 0))
    draw = ImageDraw.Draw(layer)
    for ring in rings_level0:
        pts = [(float(x) / scale, float(y) / scale) for x, y in ring]
        if len(pts) >= 3:
            draw.polygon(pts, fill=fill_rgba, outline=outline_rgba)
    return np.asarray(Image.alpha_composite(base, layer).convert("RGB"))
