"""Connected-component labeling, plain PyTorch.

Counterpart of the JAX package's ``ops/components.py``: labels start as
each foreground pixel's linear index, and every relaxation pass takes the
minimum over each horizontal run of foreground, then over each vertical
run, until nothing changes (at most 1 + ``max_iters`` passes). Background
is ``INF``. These are the reference semantics of the K2 kernel
(``ops/cc_sizes.py``), whose plain version calls ``label_components``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

INF = 2**30


def _run_min_lastdim(lbl: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Minimum of ``lbl`` over each run of ``mask`` along the last axis,
    INF off the mask."""
    prev = F.pad(mask[..., :-1], (1, 0), value=False)
    start = (mask & ~prev).reshape(-1)
    run = torch.cumsum(start, 0) - 1
    m = mask.reshape(-1)
    n_runs = int(start.sum())
    mins = torch.full((n_runs,), INF, dtype=lbl.dtype, device=lbl.device)
    mins = mins.scatter_reduce(0, run[m], lbl.reshape(-1)[m], "amin")
    out = torch.where(m, mins[run.clamp(min=0)], INF)
    return out.reshape(lbl.shape)


def _relax(lbl: torch.Tensor, mask: torch.Tensor, mask_t: torch.Tensor) -> torch.Tensor:
    lbl = _run_min_lastdim(lbl, mask)
    return _run_min_lastdim(lbl.transpose(-1, -2).contiguous(), mask_t).transpose(-1, -2)


def label_components(mask: torch.Tensor, max_iters: int = 256) -> torch.Tensor:
    """(B, H, W) bool → (B, H, W) int32 4-connected labels (minimum linear
    pixel index per component; INF background). Each tile gets exactly the
    passes it would get alone: a pass leaves a converged tile unchanged."""
    b, h, w = mask.shape
    mask = mask.bool()
    mask_t = mask.transpose(-1, -2).contiguous()
    pix = torch.arange(h * w, dtype=torch.int32, device=mask.device).reshape(1, h, w)
    lbl = torch.where(mask, pix, INF)
    new = _relax(lbl, mask, mask_t)
    changed = bool((new != lbl).any())
    lbl = new
    i = 0
    while changed and i < max_iters:
        new = _relax(lbl, mask, mask_t)
        changed = bool((new != lbl).any())
        lbl = new
        i += 1
    return lbl.contiguous()


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
