"""Step 8/8 — thumbnail overlays of class polygons, without matplotlib.

Counterpart of the JAX package's ``pipeline/overlay.py`` (the reference's
``create_and_overlay_polygon_from_prediction.py:429-634``): load a slide
thumbnail, scale polygon geometry from level-0 px into thumbnail px (affine
scale about the origin, ``scale_geometry_to_thumb`` ``:453-461``), and
write one image with all classes and one per class, each class in the
10-colour palette (matplotlib's tab10, in class order).

The images are drawn here, not by matplotlib: the thumbnail at its own
resolution, each class's rings filled even-odd at pixel centres and
blended once over the thumbnail at alpha 0.35 (all classes) or 0.4 (per
class), then each ring's 1-px outline in the class colour. There is no
legend, title or axis frame; the JAX package's figures (12" / 10" at 200
dpi, with them) differ from these pixel for pixel (ROADMAP Queue 3,
Decided). The file names and their de-duplication are the JAX package's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np

from path_gene_multimodal_tpu_torch.core.artifacts import sanitize_for_filename
from path_gene_multimodal_tpu_torch.io.png import write_png
from path_gene_multimodal_tpu_torch.io.slide import SlideReader
from path_gene_multimodal_tpu_torch.pipeline.morphology import _hex_rgb, draw_polyline

# 10-color palette (reference :507-510 uses matplotlib tab10)
PALETTE = (
    "#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
    "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf",
)


def load_thumbnail_with_scale(
    slide: SlideReader, thumb_size: tuple[int, int] = (2000, 2000)
) -> tuple[np.ndarray, float, float]:
    """Thumbnail + per-axis scale factors thumb_px / level0_px
    (``load_svs_thumbnail`` :429-449)."""
    thumb = slide.get_thumbnail(thumb_size)
    w0, h0 = slide.level_dimensions[0]
    return thumb, thumb.shape[1] / w0, thumb.shape[0] / h0


def scale_ring_to_thumb(ring: np.ndarray, sx: float, sy: float) -> np.ndarray:
    """Affine scale about the origin (``scale_geometry_to_thumb`` :453-461)."""
    out = np.asarray(ring, np.float64).copy()
    out[:, 0] *= sx
    out[:, 1] *= sy
    return out


def fill_ring(shape: tuple[int, int], ring: np.ndarray) -> np.ndarray:
    """(H, W) bool: the pixels whose centres lie inside the closed ring
    (K, 2) (x, y), by the even-odd rule: each edge crossing a row's centre
    line flips the parity of every pixel centre right of the crossing."""
    h, w = shape
    p = np.asarray(ring, np.float64)
    if len(p) < 3:
        return np.zeros(shape, bool)
    a, b = p, np.roll(p, -1, axis=0)
    toggles = np.zeros((h, w + 1), np.int32)
    for (x0, y0), (x1, y1) in zip(a, b):
        if y0 == y1:
            continue
        lo, hi = min(y0, y1), max(y0, y1)
        rows = np.arange(max(int(np.ceil(lo - 0.5)), 0), min(int(np.ceil(hi - 0.5)), h))
        if not len(rows):
            continue
        yc = rows + 0.5
        xc = x0 + (yc - y0) * (x1 - x0) / (y1 - y0)
        cols = np.clip(np.ceil(xc - 0.5).astype(np.int64), 0, w)
        np.add.at(toggles, (rows, cols), 1)
    return (np.cumsum(toggles, axis=1)[:, :w] % 2).astype(bool)


def draw_overlay(
    thumb: np.ndarray,
    rings_by_colour: Sequence[tuple[str, Sequence[np.ndarray]]],
    alpha: float,
) -> np.ndarray:
    """The thumbnail with, for each (colour, rings) in turn, the rings'
    filled area blended at ``alpha`` and their 1-px outlines."""
    img = np.array(thumb, dtype=np.float64)
    shape = img.shape[:2]
    for colour, rings in rings_by_colour:
        inside = np.zeros(shape, bool)
        for r in rings:
            inside |= fill_ring(shape, r)
        rgb = np.asarray(_hex_rgb(colour), np.float64)
        img[inside] = (1.0 - alpha) * img[inside] + alpha * rgb
    out = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    for colour, rings in rings_by_colour:
        for r in rings:
            draw_polyline(out, np.concatenate([r, r[:1]]), _hex_rgb(colour))
    return out


def plot_overlays_all_classes(
    thumb: np.ndarray,
    features: Sequence[Mapping[str, Any]],
    classes: Sequence[str],
    sx: float,
    sy: float,
    out_path: str | Path,
    alpha: float = 0.35,
) -> Path:
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    color_of = {c: PALETTE[i % len(PALETTE)] for i, c in enumerate(classes)}
    by_colour: dict[str, list[np.ndarray]] = {}
    for f in features:
        colour = color_of.get(f["class_name"], "#000000")
        by_colour.setdefault(colour, []).append(scale_ring_to_thumb(f["exterior"], sx, sy))
    return write_png(out_path, draw_overlay(thumb, list(by_colour.items()), alpha))


def plot_overlays_per_class(
    thumb: np.ndarray,
    features: Sequence[Mapping[str, Any]],
    classes: Sequence[str],
    sx: float,
    sy: float,
    out_dir: str | Path,
    stem: str,
    alpha: float = 0.4,
) -> dict[str, Path]:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    by_class: dict[str, list] = {}
    for f in features:
        by_class.setdefault(f["class_name"], []).append(f)
    outputs: dict[str, Path] = {}
    used_names: set[str] = set()
    for i, c in enumerate(classes):
        feats = by_class.get(c)
        if not feats:
            continue
        rings = [scale_ring_to_thumb(f["exterior"], sx, sy) for f in feats]
        name = sanitize_for_filename(c)
        if name in used_names:
            # two classes sanitizing to the same token ("tumor/stroma" vs
            # "tumor stroma") must not overwrite each other's PNG
            name = f"{name}_{i}"
        used_names.add(name)
        # reference contract: per-class overlays are `<class>.png` in the
        # per-slide dir (create_and_overlay_polygon_from_prediction.py:621-622)
        path = out_dir / f"{name}.png"
        write_png(path, draw_overlay(thumb, [(PALETTE[i % len(PALETTE)], rings)], alpha))
        outputs[c] = path
    return outputs


def run_overlays(
    slide: SlideReader,
    features: Sequence[Mapping[str, Any]],
    classes: Sequence[str],
    out_dir: str | Path,
    stem: str,
    thumb_size: tuple[int, int] = (2000, 2000),
) -> dict[str, Any]:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    thumb, sx, sy = load_thumbnail_with_scale(slide, thumb_size)
    # reference contract: `<slide>_all_classes_overlay.png`
    # (create_and_overlay_polygon_from_prediction.py:497)
    all_path = plot_overlays_all_classes(
        thumb, features, classes, sx, sy, out_dir / f"{stem}_all_classes_overlay.png",
    )
    per_class = plot_overlays_per_class(thumb, features, classes, sx, sy, out_dir, stem)
    return {"overlay_all_path": all_path, "per_class_outputs": per_class}
