"""HoverNeXt result plotting / TSV utilities, in the port.

The JAX package's ``pipeline/plotting.py`` (the reference's
``hovernet_plotting.py``, SURVEY.md §2 C19):

- ``load_centroid_tsv``: robust (x, y, name) TSV loader (``:4-40``) —
  tolerates missing headers, extra columns, comment lines;
- ``class_map_from_instances``: instance map + per-instance class lookup →
  per-pixel class map (``cls_map = lookup[inst_map]``, ``:44-73``);
- ``merge_pred_tsvs``: per-class ``pred_*.tsv`` centroid merge (``:77-108``);
- ``plot_class_centroids``: class-coloured centroid dots (``:113-154``).

The port never loads matplotlib: the figure is drawn here, in the JAX
package's class colours (``_CLASS_COLORS``, as RGB numbers), as filled
dots of diameter ``point_size`` px over the background (or a white
canvas), with no legend or axes, and written through ``io/png.py``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import numpy as np
import pandas as pd

from path_gene_multimodal_tpu_torch.config import TYPE_NAMES
from path_gene_multimodal_tpu_torch.io.png import write_png

# the JAX package's colours: #d62728, #2ca02c, #1f77b4, #7f7f7f, #ff7f0e
_CLASS_COLORS = {
    1: (214, 39, 40),  # neoplastic
    2: (44, 160, 44),  # inflammatory
    3: (31, 119, 180),  # connective
    4: (127, 127, 127),  # dead
    5: (255, 127, 14),  # epithelial
}
_UNKNOWN_COLOR = (0, 0, 0)
# a canvas without a background: the JAX figure's 10 in at 200 dpi
CANVAS_PX = 2000


def load_centroid_tsv(path: str | Path) -> pd.DataFrame:
    """Robust TSV loader → columns [x, y, name]. Accepts headered or
    headerless files, extra columns, '#' comments."""
    path = Path(path)
    df = pd.read_csv(path, sep="\t", comment="#", header=None, dtype=str)
    # detect header row: first row not parseable as float in col 0
    first = df.iloc[0, 0]
    try:
        float(first)
        header = None
    except (TypeError, ValueError):
        header = [str(c).strip().lower() for c in df.iloc[0]]
        df = df.iloc[1:].reset_index(drop=True)
    if header and "x" in header and "y" in header:
        xi, yi = header.index("x"), header.index("y")
        ni = header.index("name") if "name" in header else None
    else:
        xi, yi, ni = 0, 1, (2 if df.shape[1] > 2 else None)
    out = pd.DataFrame(
        {
            "x": pd.to_numeric(df.iloc[:, xi], errors="coerce"),
            "y": pd.to_numeric(df.iloc[:, yi], errors="coerce"),
            "name": df.iloc[:, ni].astype(str) if ni is not None else path.stem,
        }
    ).dropna(subset=["x", "y"])
    return out.reset_index(drop=True)


def class_map_from_instances(
    inst_map: np.ndarray, inst_types: Mapping[int, int]
) -> np.ndarray:
    """Per-pixel class map via lookup-table gather (``cls_map =
    lookup[inst_map]``) — inst_types from class_inst.json {id: [type, ...]}."""
    inst_map = np.asarray(inst_map)
    max_id = int(inst_map.max()) if inst_map.size else 0
    lookup = np.zeros(max_id + 1, np.int32)
    for k, t in inst_types.items():
        k = int(k)
        if 0 <= k <= max_id:
            lookup[k] = int(t[0] if isinstance(t, (list, tuple)) else t)
    return lookup[inst_map]


def merge_pred_tsvs(tsv_dir: str | Path, pattern: str = "pred_*.tsv") -> pd.DataFrame:
    """Merge per-class centroid TSVs; class name from the filename
    (``pred_<class>.tsv``)."""
    frames = []
    for path in sorted(Path(tsv_dir).glob(pattern)):
        df = load_centroid_tsv(path)
        stem = path.stem
        # strip the conventional prefix only when present — a custom glob
        # like '*.tsv' must not lose the first 5 chars of the class name
        df["class_name"] = stem[len("pred_"):] if stem.startswith("pred_") else stem
        frames.append(df)
    if not frames:
        return pd.DataFrame(columns=["x", "y", "name", "class_name"])
    return pd.concat(frames, ignore_index=True)


def draw_dots(img: np.ndarray, xs, ys, diameter: float, color: tuple[int, int, int]) -> None:
    """Filled discs of ``diameter`` px centred on the rounded (x, y) points,
    into the RGB uint8 ``img`` in place, clipped to the image."""
    r = max(diameter / 2.0, 0.5)
    k = int(np.floor(r))
    dy, dx = np.mgrid[-k:k + 1, -k:k + 1]
    inside = dx * dx + dy * dy <= r * r
    dx, dy = dx[inside], dy[inside]
    cx = np.rint(np.asarray(xs, np.float64)).astype(np.int64)
    cy = np.rint(np.asarray(ys, np.float64)).astype(np.int64)
    px, py = (cx[:, None] + dx).ravel(), (cy[:, None] + dy).ravel()
    h, w = img.shape[:2]
    ok = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    img[py[ok], px[ok]] = color


def plot_class_centroids(
    centroids: pd.DataFrame,
    out_path: str | Path,
    class_column: str = "class_name",
    background: np.ndarray | None = None,
    point_size: float = 3.0,
) -> Path:
    """Class-coloured centroid dots (``:113-154``) → a PNG. Over
    ``background`` (uint8, RGB or grey) the centroids are in its pixels;
    without one, on a white canvas whose longer side is at most
    ``CANVAS_PX`` (the centroids scaled down to fit when they span more)."""
    xs = centroids["x"].to_numpy(np.float64)
    ys = centroids["y"].to_numpy(np.float64)
    if background is not None:
        img = np.array(background, dtype=np.uint8)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        scale = 1.0
    else:
        extent = max(float(xs.max(initial=0.0)), float(ys.max(initial=0.0)), 1.0)
        scale = min(1.0, (CANVAS_PX - 1) / extent)
        w = int(np.ceil(max(xs.max(initial=0.0), 0.0) * scale)) + 1
        h = int(np.ceil(max(ys.max(initial=0.0), 0.0) * scale)) + 1
        img = np.full((h, w, 3), 255, np.uint8)
    name_to_id = {v: k for k, v in TYPE_NAMES.items()}
    for cls, group in centroids.groupby(class_column):
        color = _CLASS_COLORS.get(name_to_id.get(str(cls)), _UNKNOWN_COLOR)
        draw_dots(img, group["x"].to_numpy(np.float64) * scale,
                  group["y"].to_numpy(np.float64) * scale, point_size, color)
    return write_png(out_path, img)
