"""Probability-map splatting on the tensors' device.

Counterpart of the JAX package's ``ops/scatter.py`` (the reference's
per-tile loop ``make_prob_map_for_task``, ``molecular_feature_extraction.py:
156-190``): each tile's probability is added over its thumbnail-space
footprint beside a count map, and the map is the mean, clipped to [0, 1].
Footprint pixels outside the thumbnail are dropped. The sums are
``index_put_(accumulate=True)``, float atomics on the card, so their
order is free: the counts are exact integers in f32, the maps agree with
any other order to f32 rounding.
"""

from __future__ import annotations

import torch


def _footprint(tile_xy: torch.Tensor, out_h: int, out_w: int, box: int):
    """(flat pixel index of every in-bounds footprint pixel, its tile)."""
    n = tile_xy.shape[0]
    d = torch.arange(box, dtype=torch.int64, device=tile_xy.device)
    xy = tile_xy.to(torch.int64)
    ys = (xy[:, 1, None, None] + d[None, :, None]).expand(n, box, box).reshape(-1)
    xs = (xy[:, 0, None, None] + d[None, None, :]).expand(n, box, box).reshape(-1)
    tile = torch.arange(n, device=tile_xy.device).repeat_interleave(box * box)
    keep = (ys >= 0) & (ys < out_h) & (xs >= 0) & (xs < out_w)
    return (ys * out_w + xs)[keep], tile[keep]


def _count(flat: torch.Tensor, pixels: int) -> torch.Tensor:
    counts = torch.zeros(pixels, dtype=torch.float32, device=flat.device)
    return counts.index_put_((flat,), torch.ones_like(flat, dtype=torch.float32),
                             accumulate=True)


def footprint_counts(tile_xy: torch.Tensor, out_h: int, out_w: int, box: int) -> torch.Tensor:
    """(out_h, out_w) f32: how many tile footprints cover each pixel."""
    flat, _ = _footprint(tile_xy, out_h, out_w, box)
    return _count(flat, out_h * out_w).view(out_h, out_w)


def splat_prob_map(tile_xy: torch.Tensor, probs: torch.Tensor, out_h: int, out_w: int,
                   box: int) -> torch.Tensor:
    """tile_xy: (N, 2) tile top-left (x, y) in thumbnail px, integer.
    probs: (T, N) per-task tile probabilities. box: the footprint's side in
    thumbnail px. → (T, out_h, out_w) f32 mean-probability maps, clipped to
    [0, 1], 0 where no tile lands; on ``probs``'s device."""
    tile_xy = tile_xy.to(probs.device)
    flat, tile = _footprint(tile_xy, out_h, out_w, box)
    counts = _count(flat, out_h * out_w)
    t = probs.shape[0]
    accum = torch.zeros((t, out_h * out_w), dtype=torch.float32, device=probs.device)
    rows = torch.arange(t, device=probs.device)[:, None].expand(t, flat.numel())
    accum.index_put_((rows.reshape(-1), flat.repeat(t)),
                     probs.float()[:, tile].reshape(-1), accumulate=True)
    maps = accum / torch.clamp(counts, min=1.0)
    return maps.clamp_(0.0, 1.0).view(t, out_h, out_w)
