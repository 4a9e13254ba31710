"""Tile-grid ops: grid generation, foreground pooling, tiles↔grid rasterize.

A copy of the JAX package's ``ops/gridops.py`` (without the jitted
``tile_foreground_fraction``, whose edges the canonical-shape variant takes
from the host), in torch on any device. Replaces the reference's per-tile
Python loops:

- tile grid + foreground filter: Mussel tessellation (``tiling.py``);
- ``infer_tile_size``: mode of positive coordinate diffs
  (``create_and_overlay_polygon_from_prediction.py:60-72``,
  ``aggregated_hovernet_run.py:14-24``);
- ``rasterize_tiles`` / ``grid_lookup``: 1 tile → 1 grid pixel
  (``create_and_overlay_polygon_from_prediction.py:79-137``).

The integral image is summed in int32 (the JAX package sums in f32; every
partial sum is an integer below 2^24 there, so both are exact).
"""

from __future__ import annotations

import numpy as np
import torch


def full_tile_grid(slide_w: int, slide_h: int, patch_size: int) -> np.ndarray:
    """All top-left (x, y) level-0 coords of a non-overlapping patch grid.
    Row-major (y outer, x inner) — the order the reference's H5s use."""
    nx = slide_w // patch_size
    ny = slide_h // patch_size
    xs = np.arange(nx, dtype=np.int64) * patch_size
    ys = np.arange(ny, dtype=np.int64) * patch_size
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)


def tile_foreground_fraction_edges(
    mask: torch.Tensor,
    y0: np.ndarray,
    y1: np.ndarray,
    x0: np.ndarray,
    x1: np.ndarray,
) -> torch.Tensor:
    """Per-tile foreground fraction of a bool (H, W) mask over the tiles
    whose edges (in mask pixels) the host computed (``tile_edges_for_scale``):
    an integral image on the mask's device. Returns (len(y0), len(x0))
    float32 fractions (a tile of area 0 has fraction 0)."""
    mh, mw = mask.shape
    dev = mask.device
    ii = torch.zeros((mh + 1, mw + 1), dtype=torch.int32, device=dev)
    ii[1:, 1:] = torch.cumsum(torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32), 1,
                              dtype=torch.int32)
    e = [torch.as_tensor(np.clip(np.asarray(v, np.int64), 0, lim), device=dev)
         for v, lim in ((y0, mh), (y1, mh), (x0, mw), (x1, mw))]
    y0t, y1t, x0t, x1t = e
    counts = (ii[y1t[:, None], x1t[None, :]] - ii[y0t[:, None], x1t[None, :]]
              - ii[y1t[:, None], x0t[None, :]] + ii[y0t[:, None], x0t[None, :]])
    areas = (y1t - y0t)[:, None] * (x1t - x0t)[None, :]
    return counts.float() / torch.clamp(areas.float(), min=1.0)


def tile_edges_for_scale(
    mh: int, mw: int, patch_size: int, mask_scale: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Host-side tile-edge arrays (y0, y1, x0, x1, ny, nx) in mask pixels,
    the edge products in float32 as the JAX package rounds them."""
    tile_m = patch_size / mask_scale
    ny = int(np.floor(mh / tile_m))
    nx = int(np.floor(mw / tile_m))
    tile_m32 = np.float32(tile_m)
    ty = np.arange(ny, dtype=np.float32)
    tx = np.arange(nx, dtype=np.float32)
    y0 = np.clip(np.round(ty * tile_m32).astype(np.int32), 0, mh)
    y1 = np.clip(np.round((ty + 1.0).astype(np.float32) * tile_m32).astype(np.int32), 0, mh)
    x0 = np.clip(np.round(tx * tile_m32).astype(np.int32), 0, mw)
    x1 = np.clip(np.round((tx + 1.0).astype(np.float32) * tile_m32).astype(np.int32), 0, mw)
    return y0, y1, x0, x1, ny, nx


def infer_tile_size(coords: np.ndarray, default: int = 224) -> int:
    """Tile size = mode of positive nearest-neighbor diffs of sorted unique
    x (fallback y) coordinates — reference semantics
    (create_and_overlay_polygon_from_prediction.py:60-72)."""
    coords = np.asarray(coords)
    for axis in (0, 1):
        vals = np.unique(coords[:, axis])
        if len(vals) >= 2:
            diffs = np.diff(vals)
            diffs = diffs[diffs > 0]
            if len(diffs):
                sizes, counts = np.unique(diffs, return_counts=True)
                return int(sizes[np.argmax(counts)])
    return default


def tiles_to_grid_shape(coords: np.ndarray, tile_size: int) -> tuple[int, int, int, int]:
    """Grid extent: (gw, gh, x_min, y_min), 1 tile = 1 grid px
    (create_and_overlay_polygon_from_prediction.py:79-137)."""
    coords = np.asarray(coords)
    x_min, y_min = coords[:, 0].min(), coords[:, 1].min()
    gw = int((coords[:, 0].max() - x_min) // tile_size) + 1
    gh = int((coords[:, 1].max() - y_min) // tile_size) + 1
    return gw, gh, int(x_min), int(y_min)


def rasterize_tiles(
    coords: torch.Tensor,
    values: torch.Tensor,
    gw: int,
    gh: int,
    x_min: int,
    y_min: int,
    tile_size: int,
    fill: float = 0.0,
) -> torch.Tensor:
    """Scatter per-tile values onto the (gh, gw[, C]) grid, 1 tile = 1 px.
    ``values`` may be (N,) or (N, C). Rows out of range (coords < 0 mark
    padding) are dropped."""
    gx = torch.div(coords[:, 0] - x_min, tile_size, rounding_mode="floor")
    gy = torch.div(coords[:, 1] - y_min, tile_size, rounding_mode="floor")
    valid = (coords[:, 0] >= 0) & (gx >= 0) & (gx < gw) & (gy >= 0) & (gy < gh)
    shape = (gh, gw) + tuple(values.shape[1:])
    grid = torch.full(shape, fill, dtype=values.dtype, device=values.device)
    grid[gy[valid].long(), gx[valid].long()] = values[valid]
    return grid


def grid_lookup(
    coords: torch.Tensor,
    grid: torch.Tensor,
    gw: int,
    gh: int,
    x_min: int,
    y_min: int,
    tile_size: int,
) -> torch.Tensor:
    """Gather grid values back to per-tile order (inverse of rasterize)."""
    gx = torch.div(coords[:, 0] - x_min, tile_size, rounding_mode="floor").clamp(0, gw - 1)
    gy = torch.div(coords[:, 1] - y_min, tile_size, rounding_mode="floor").clamp(0, gh - 1)
    return grid[gy.long(), gx.long()]
