"""Molecular (IDaRS) biomarker prediction: the JAX package's
``pipeline/molecular.py`` in the port (reference
``molecular_feature_extraction.py:246-349``).

1. load the annotations CSV (required-column check ``:54-66``) and select
   the TME-ROI tiles (``:69-87``);
2. run the IDaRS ResNet34 predictors (``models.resnet.IDaRSEnsemble``)
   over the selected tiles in batches of ``MolecularConfig.batch_size``,
   keeping P(class=1) per task (``:136``); the tiles are read on the host
   by ``read_region``, one after the other, as in the JAX package;
3. add the ``<task>_prob`` columns to the annotations frame and write
   ``<stem>_molecular_features.csv`` (``:293-295``);
4. a thumbnail at ``thumb_power`` (``:142-153``), the probability maps
   splatted on the ensemble's device (``ops.scatter``), an overlay PNG per
   task and a grid of them (``:193-243``), and ``<stem>_prob_maps.npz``
   when ``save_prob_maps``.

The overlays are drawn here, not by matplotlib: the thumbnail at its own
resolution, blended at ``alpha`` with matplotlib's ``jet`` colour (its
segment data, as numbers) wherever the map is above 0, the map read over
[0, 1]; the grid puts the task overlays in 3 columns. There is no
colourbar, title or axis frame (ROADMAP Queue 3, Decided). The file names
are the JAX package's: ``cli/molecular_loop.is_done`` looks for
``<stem>_msi_overlay.png``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

import numpy as np
import pandas as pd
import torch

from path_gene_multimodal_tpu_torch.config import PipelineConfig
from path_gene_multimodal_tpu_torch.core.artifacts import read_annotations_csv
from path_gene_multimodal_tpu_torch.io.png import write_png
from path_gene_multimodal_tpu_torch.io.slide import SlideReader
from path_gene_multimodal_tpu_torch.models.resnet import IDaRSEnsemble
from path_gene_multimodal_tpu_torch.ops.scatter import splat_prob_map
from path_gene_multimodal_tpu_torch.utils.log import get_logger

DEFAULT_BASE_POWER = 40.0  # objective power at level 0 (0.25 mpp scanners)

# matplotlib's ``jet`` (``matplotlib/_cm.py::_jet_data``): (x, value) knots
# of each channel, linear between them
_JET = {
    "red": ((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0), (1.0, 0.5)),
    "green": ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0), (0.91, 0.0), (1.0, 0.0)),
    "blue": ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0), (1.0, 0.0)),
}
GRID_COLUMNS = 3


@dataclass
class MolecularResult:
    features: pd.DataFrame
    prob_maps: np.ndarray | None  # (T, H, W)
    thumb: np.ndarray | None
    artifacts: dict


def load_tile_annotations(csv_path: str | Path) -> pd.DataFrame:
    return read_annotations_csv(csv_path)


def select_tme_tiles(df: pd.DataFrame) -> pd.DataFrame:
    sel = df[df["in_tme_roi"] == True]  # noqa: E712
    return sel.reset_index(drop=True)


def get_wsi_overview_and_dims(
    slide: SlideReader, power: float = 4.0, base_power: float | None = None
) -> tuple[np.ndarray, float]:
    """Thumbnail at the given objective power (TIAToolbox ``resolution=power,
    units="power"``, ref :142-153) → (thumb RGB, downsample = level-0 px
    per thumb px). ``base_power`` defaults to the scanner power derived
    from ``slide.mpp`` (10 / mpp: 0.25 mpp ≈ 40x, 0.5 ≈ 20x); a slide
    without an mpp is taken as 40x."""
    if base_power is None:
        mpp = getattr(slide, "mpp", None)
        base_power = (10.0 / mpp) if mpp else DEFAULT_BASE_POWER
    ds = base_power / power
    w0, h0 = slide.level_dimensions[0]
    thumb = slide.get_thumbnail((max(int(w0 / ds), 1), max(int(h0 / ds), 1)))
    return thumb, w0 / thumb.shape[1]


def extract_molecular_features(
    slide: SlideReader,
    annotations_csv: str | Path,
    out_dir: str | Path,
    stem: str,
    ensemble: IDaRSEnsemble,
    cfg: PipelineConfig,
    batch_size: int | None = None,
    write_artifacts: bool = True,
) -> MolecularResult:
    logger = get_logger()
    out_dir = Path(out_dir)
    mcfg = cfg.molecular
    tasks = list(ensemble.tasks)
    sel = select_tme_tiles(load_tile_annotations(annotations_csv))
    if len(sel) == 0:
        raise ValueError("no TME-ROI tiles for molecular prediction")

    tile = cfg.patch_size
    batch = batch_size or mcfg.batch_size
    coords = sel[["x", "y"]].to_numpy(np.int64)
    outs = []
    for start in range(0, len(coords), batch):
        tiles = np.stack([slide.read_region((int(x), int(y)), 0, (tile, tile))
                          for x, y in coords[start:start + batch]])
        outs.append(ensemble(tiles))  # enqueued on the device
    probs_dev = torch.cat(outs, dim=1)  # (T, N)

    thumb, ds = get_wsi_overview_and_dims(slide, power=mcfg.thumb_power)
    box = max(int(round(tile / ds)), 1)
    xy_thumb = torch.from_numpy((coords / ds).astype(np.int32))
    maps = splat_prob_map(xy_thumb, probs_dev, thumb.shape[0], thumb.shape[1], box).cpu().numpy()
    probs = probs_dev.cpu().numpy()

    features = sel.copy()
    for ti, task in enumerate(tasks):
        features[f"{task}_prob"] = probs[ti]

    artifacts: dict = {}
    if write_artifacts:
        out_dir.mkdir(parents=True, exist_ok=True)
        csv_path = out_dir / f"{stem}_molecular_features.csv"
        features.to_csv(csv_path, index=False)
        artifacts["csv_path"] = csv_path
        artifacts.update(save_overlays(thumb, maps, tasks, out_dir, stem))
        if mcfg.save_prob_maps:
            npz = out_dir / f"{stem}_prob_maps.npz"
            np.savez_compressed(npz, **{t: maps[i] for i, t in enumerate(tasks)})
            artifacts["prob_maps_path"] = npz
        logger.info("molecular: %d tiles × %d tasks → %s", len(sel), len(tasks), csv_path)
    return MolecularResult(features=features, prob_maps=maps, thumb=thumb, artifacts=artifacts)


def jet_lut(n: int = 256) -> np.ndarray:
    """(n, 3) f64 in [0, 1]: matplotlib's ``jet`` sampled at n levels."""
    x = np.linspace(0.0, 1.0, n)
    return np.stack([np.interp(x, *np.asarray(_JET[c]).T) for c in ("red", "green", "blue")], 1)


def overlay_prob_map(thumb: np.ndarray, prob_map: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """The thumbnail blended at ``alpha`` with ``jet`` where ``prob_map`` >
    0 (colour index floor(p * 256), 1.0 in the top one, as matplotlib maps
    [vmin, vmax] = [0, 1]); uint8 (H, W, 3)."""
    lut = jet_lut()
    idx = np.clip((np.clip(prob_map, 0.0, 1.0) * len(lut)).astype(np.int64), 0, len(lut) - 1)
    colour = lut[idx] * 255.0
    blend = (1.0 - alpha) * thumb.astype(np.float64) + alpha * colour
    return np.where((prob_map > 0)[..., None], np.rint(blend), thumb).astype(np.uint8)


def save_overlays(
    thumb: np.ndarray,
    maps: np.ndarray,
    tasks: Sequence[str],
    out_dir: Path,
    stem: str,
    alpha: float = 0.5,
) -> dict:
    """Per-task probability overlay PNGs + one grid image of them, 3
    columns, unused cells white (ref :193-243)."""
    out: dict = {"overlays": {}}
    panels = []
    for i, task in enumerate(tasks):
        img = overlay_prob_map(thumb, maps[i], alpha)
        out["overlays"][task] = write_png(out_dir / f"{stem}_{task}_overlay.png", img)
        panels.append(img)
    rows = -(-len(panels) // GRID_COLUMNS)
    h, w = thumb.shape[:2]
    grid = np.full((rows * h, GRID_COLUMNS * w, 3), 255, np.uint8)
    for i, img in enumerate(panels):
        r, c = divmod(i, GRID_COLUMNS)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = img
    out["grid_path"] = write_png(out_dir / f"{stem}_molecular_grid.png", grid)
    return out
