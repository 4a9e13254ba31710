"""Connected-component labeling, plain PyTorch.

Counterpart of the JAX package's ``ops/components.py``: labels start as
each foreground pixel's linear index (or given seeds), and every relaxation
pass takes the minimum over each horizontal run of foreground, then over
each vertical run, then (8-connectivity) over the four diagonal neighbours
one after another, until nothing changes (at most 1 + ``max_iters``
passes). Background is ``INF``. These are the reference semantics of the
K2 kernel (``ops/cc_sizes.py``) and of K5 and K6 (``ops/cc.py``), whose
plain versions call ``relax_fixpoint``.

``remove_small_objects`` / ``remove_small_holes`` label one 2-D mask with
K5 (``ops/cc.py::label_components_tiled``): its kernel on a CUDA tensor, its
plain version on a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

INF = 2**30
DIAGONALS = ((1, 1), (1, -1), (-1, 1), (-1, -1))  # the JAX relax order


def _run_min_lastdim(lbl: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Minimum of ``lbl`` over each run of ``mask`` along the last axis,
    INF off the mask."""
    prev = F.pad(mask[..., :-1], (1, 0), value=False)
    start = (mask & ~prev).reshape(-1)
    run = torch.cumsum(start, 0) - 1
    m = mask.reshape(-1)
    n_runs = int(start.sum())
    if n_runs == 0:
        return torch.full_like(lbl, INF)
    mins = torch.full((n_runs,), INF, dtype=lbl.dtype, device=lbl.device)
    mins = mins.scatter_reduce(0, run[m], lbl.reshape(-1)[m], "amin")
    out = torch.where(m, mins[run.clamp(min=0)], INF)
    return out.reshape(lbl.shape)


def shift(x: torch.Tensor, dy: int, dx: int, fill: int) -> torch.Tensor:
    """``out[..., y, x] = x[..., y - dy, x - dx]`` over the last two axes,
    ``fill`` where that falls outside (the JAX package's ``_shift``)."""
    h, w = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1), value=fill)
    return p[..., 1 - dy : 1 - dy + h, 1 - dx : 1 - dx + w]


def _relax(lbl, mask, mask_t, connectivity: int) -> torch.Tensor:
    lbl = _run_min_lastdim(lbl, mask)
    lbl = _run_min_lastdim(lbl.transpose(-1, -2).contiguous(), mask_t).transpose(-1, -2)
    if connectivity == 2:
        for dy, dx in DIAGONALS:
            lbl = torch.where(mask, torch.minimum(lbl, shift(lbl, dy, dx, INF)), INF)
    return lbl.contiguous()


def relax_fixpoint(mask: torch.Tensor, seeds: torch.Tensor, connectivity: int = 1,
                   max_iters: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile seeded fixpoint over (B, H, W): one first relaxation, then
    up to ``max_iters`` more while the tile changed. Returns the labels and
    each tile's relaxation count. The tiles are relaxed together: a pass
    leaves a converged tile unchanged, so each gets exactly the passes it
    would get alone."""
    if connectivity not in (1, 2):
        raise ValueError(f"connectivity must be 1 or 2, got {connectivity}")
    mask = mask.bool()
    mask_t = mask.transpose(-1, -2).contiguous()
    lbl = _relax(seeds, mask, mask_t, connectivity)
    changed = (lbl != seeds).flatten(1).any(1)
    count = torch.ones(mask.shape[0], dtype=torch.int64, device=mask.device)
    i = 0
    while bool(changed.any()) and i < max_iters:
        new = _relax(lbl, mask, mask_t, connectivity)
        count += changed
        changed = (new != lbl).flatten(1).any(1)
        lbl = new
        i += 1
    return lbl, count


def index_seeds(mask: torch.Tensor) -> torch.Tensor:
    """(B, H, W) → each foreground pixel's linear index in its tile, INF
    elsewhere."""
    b, h, w = mask.shape
    pix = torch.arange(h * w, dtype=torch.int32, device=mask.device).reshape(1, h, w)
    return torch.where(mask.bool(), pix, INF)


def label_components(mask: torch.Tensor, max_iters: int = 256,
                     connectivity: int = 1) -> torch.Tensor:
    """(B, H, W) bool → (B, H, W) int32 labels (minimum linear pixel index
    per component; INF background), ``connectivity`` 1 (4-neighbours) or 2
    (8-neighbours)."""
    return relax_fixpoint(mask, index_seeds(mask), connectivity, max_iters)[0]


def component_sizes(lbl: torch.Tensor) -> torch.Tensor:
    """(H, W) labels (INF background) → per-pixel component size (0 on
    background)."""
    return component_sizes_batch(lbl[None])[0]


def component_sizes_batch(lbl: torch.Tensor) -> torch.Tensor:
    """(B, H, W) labels (INF background) → per-pixel component size (0 on
    background)."""
    b, h, w = lbl.shape
    n = h * w
    flat = lbl.reshape(b, n).long()
    fg = flat < INF
    idx = torch.where(fg, flat, n)
    counts = torch.zeros((b, n + 1), dtype=torch.int32, device=lbl.device)
    counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    sizes = torch.where(fg, counts.gather(1, idx), 0)
    return sizes.reshape(b, h, w)


def remove_small_objects(mask: torch.Tensor, min_size: int,
                         connectivity: int = 1) -> torch.Tensor:
    """Drop the components of a 2-D mask with area < ``min_size`` (skimage
    semantics: strict <), labeled by K5."""
    from path_gene_multimodal_tpu_torch.ops.cc import label_components_tiled

    mask = mask.bool()
    return mask & (component_sizes(label_components_tiled(mask, connectivity)) >= min_size)


def remove_small_holes(mask: torch.Tensor, area_threshold: int,
                       connectivity: int = 1) -> torch.Tensor:
    """Fill holes with area <= ``area_threshold`` (skimage semantics:
    complement → remove_small_objects(threshold + 1) → complement)."""
    return ~remove_small_objects(~mask.bool(), area_threshold + 1, connectivity)


def compact_labels(lbl: np.ndarray) -> tuple[np.ndarray, int]:
    """Host-side: sparse labels → consecutive 1..N (0 = background),
    matching skimage.measure.label output conventions."""
    lbl = np.asarray(lbl)
    out = np.zeros(lbl.shape, np.int32)
    fg = lbl < INF
    if fg.any():
        uniq, inv = np.unique(lbl[fg], return_inverse=True)
        out[fg] = inv.astype(np.int32) + 1
        return out, len(uniq)
    return out, 0


def compact_labels_device(lbl: torch.Tensor) -> torch.Tensor:
    """(B, H, W) min-index labels (INF background) → dense ids 1..N per
    tile by root pixel order, 0 background, int32. Precondition (as in the
    JAX package): every label value is the index of a pixel carrying it."""
    b, h, w = lbl.shape
    n = h * w
    flat = lbl.reshape(b, n)
    valid = flat < INF
    present = (flat == torch.arange(n, dtype=flat.dtype, device=lbl.device)).int()
    ranks = torch.cumsum(present, 1)
    new = torch.where(valid, ranks.gather(1, torch.where(valid, flat, 0).long()), 0)
    return new.reshape(b, h, w).to(torch.int32)
