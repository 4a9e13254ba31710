"""K5 and K6: connected-component labeling of large masks and of batches.

Counterpart of the JAX package's ``ops/pallas/cc.py``. Each wrapper
launches ``csrc/cc.cu`` on a CUDA tensor and runs its ``*_plain`` twin on a
CPU tensor; both follow the Pallas kernels step for step, so on the card
the kernel equals the plain version in every pixel, caps included:

- ``label_components_batch`` (K6, ``pallas_label_components``): (B, H, W)
  → per-tile labels, each tile's seeded fixpoint seeded by pixel index, at
  most 1 + ``max_iters`` relaxations;
- ``label_components_tiled`` (K5, ``pallas_label_components_tiled``): one
  (H, W) mask, padded to ``tile`` multiples (padding is background), seeds
  = original-width linear indices. Rounds: ``propagate(seeds0)``,
  ``propagate(border_min(first))``, then while anything changed and fewer
  than ``max_outer`` rounds ran, ``propagate(border_min(lbl))``. A
  propagate is the seeded fixpoint in every ``tile`` x ``tile`` block (at
  most 1 + ``max_iters`` relaxations each, tile borders read as
  background); the border-min takes each foreground pixel's minimum over
  itself and its 4 (or 8) neighbours across the whole mask.

Labels are the component minimum linear index, ``INF`` on background; at
connectivity 2 the diagonal relax runs in the order (1,1), (1,-1), (-1,1),
(-1,-1). A ``counts`` tensor (int64 (2,), on the mask's device), when
given, gets the relaxations (summed over tiles) and the propagate rounds
added to it, by the kernel on the card.

On the card the outer loop of K5 reads its "changed" flag on the host once
per round (at most ``max_outer`` + 1 synchronisations).
"""

from __future__ import annotations

import torch

from path_gene_multimodal_tpu_torch.ops import cuda
from path_gene_multimodal_tpu_torch.ops.components import INF, index_seeds, relax_fixpoint, shift


def _count(counts: torch.Tensor | None, relaxes, rounds: int) -> None:
    if counts is not None:
        counts[0] += relaxes
        counts[1] += rounds


def label_components_batch_plain(mask: torch.Tensor, connectivity: int = 1,
                                 max_iters: int = 256, counts: torch.Tensor | None = None):
    """(B, H, W) bool → (B, H, W) int32 labels."""
    lbl, n = relax_fixpoint(mask, index_seeds(mask), connectivity, max_iters)
    _count(counts, n.sum(), 1)
    return lbl


def _directions(connectivity: int):
    if connectivity == 2:
        return [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx]
    return [(-1, 0), (1, 0), (0, -1), (0, 1)]


def _border_min(lbl: torch.Tensor, maskp: torch.Tensor, connectivity: int) -> torch.Tensor:
    best = lbl
    for dy, dx in _directions(connectivity):
        best = torch.minimum(best, shift(lbl, dy, dx, INF))
    return torch.where(maskp, best, INF)


def _padded(mask: torch.Tensor, tile: int):
    h, w = mask.shape
    ph, pw = -(-h // tile) * tile, -(-w // tile) * tile
    maskp = torch.zeros((ph, pw), dtype=torch.bool, device=mask.device)
    maskp[:h, :w] = mask.bool()
    return maskp, ph, pw


def label_components_tiled_plain(mask: torch.Tensor, connectivity: int = 1, tile: int = 512,
                                 max_iters: int = 128, max_outer: int = 64,
                                 counts: torch.Tensor | None = None) -> torch.Tensor:
    """(H, W) bool → (H, W) int32 labels."""
    h, w = mask.shape
    maskp, ph, pw = _padded(mask, tile)
    ny, nx = ph // tile, pw // tile

    def tiles(a):
        return a.reshape(ny, tile, nx, tile).transpose(1, 2).reshape(ny * nx, tile, tile)

    def untile(a):
        return a.reshape(ny, nx, tile, tile).transpose(1, 2).reshape(ph, pw)

    mask_t = tiles(maskp)

    def propagate(seeds):
        lbl, n = relax_fixpoint(mask_t, tiles(seeds), connectivity, max_iters)
        _count(counts, n.sum(), 1)
        return untile(lbl)

    rows = torch.arange(ph, dtype=torch.int32, device=mask.device)[:, None]
    cols = torch.arange(pw, dtype=torch.int32, device=mask.device)[None, :]
    first = propagate(torch.where(maskp, rows * w + cols, INF))
    lbl = propagate(_border_min(first, maskp, connectivity))
    changed = bool((lbl != first).any())
    i = 1
    while changed and i < max_outer:
        new = propagate(_border_min(lbl, maskp, connectivity))
        changed = bool((new != lbl).any())
        lbl = new
        i += 1
    return lbl[:h, :w].contiguous()


def _mask_u8(mask: torch.Tensor) -> torch.Tensor:
    return mask.contiguous().view(torch.uint8) if mask.dtype == torch.bool else (mask != 0).to(torch.uint8)


def _check_args(connectivity: int, counts: torch.Tensor | None, device) -> None:
    if connectivity not in (1, 2):
        raise ValueError(f"connectivity must be 1 or 2, got {connectivity}")
    if counts is not None:
        cuda.check(counts, "counts", torch.int64, (2,))
        if counts.device != device:
            raise ValueError(f"counts: expected {device}, got {counts.device}")


def label_components_batch(mask: torch.Tensor, connectivity: int = 1, max_iters: int = 256,
                           counts: torch.Tensor | None = None) -> torch.Tensor:
    """K6: (B, H, W) bool → (B, H, W) int32 labels; the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    if not mask.is_cuda:
        return label_components_batch_plain(mask, connectivity, max_iters, counts)
    b, h, w = mask.shape
    _check_args(connectivity, counts, mask.device)
    m = _mask_u8(mask)
    cuda.check(m, "mask", torch.uint8, (b, h, w))
    new = lambda: torch.empty((b, h, w), dtype=torch.int32, device=mask.device)  # noqa: E731
    out, tmp, tmp2 = new(), new(), new()
    cuda.launch("cc", "cc_label_batch_launch", cuda.ptr(m), cuda.ptr(out), cuda.ptr(tmp),
                cuda.ptr(tmp2), cuda.ptr(counts), b, h, w, connectivity, max_iters,
                cuda.stream())
    label_components_batch.launches += 1
    return out


def label_components_tiled(mask: torch.Tensor, connectivity: int = 1, tile: int = 512,
                           max_iters: int = 128, max_outer: int = 64,
                           counts: torch.Tensor | None = None) -> torch.Tensor:
    """K5: one (H, W) bool mask → (H, W) int32 labels; the CUDA kernels on
    a CUDA tensor, the plain version on a CPU tensor. On the card: a seed
    launch, then per round a border-min launch (from the second round on)
    and a propagate launch (one block per tile), whose "changed" flag the
    host reads."""
    if not mask.is_cuda:
        return label_components_tiled_plain(mask, connectivity, tile, max_iters, max_outer,
                                            counts)
    h, w = mask.shape
    _check_args(connectivity, counts, mask.device)
    if tile <= 0 or h * w >= INF:
        raise ValueError(f"label_components_tiled takes tile > 0 and fewer than 2^30 pixels, "
                         f"got tile {tile}, {h}x{w}")
    dev = mask.device
    m = _mask_u8(mask)
    cuda.check(m, "mask", torch.uint8, (h, w))
    ph, pw = -(-h // tile) * tile, -(-w // tile) * tile
    maskp = torch.empty((ph, pw), dtype=torch.uint8, device=dev)
    new = lambda: torch.empty((ph, pw), dtype=torch.int32, device=dev)  # noqa: E731
    seeds, cur, other, tmp, tmp2 = new(), new(), new(), new(), new()
    flag = torch.empty((1,), dtype=torch.int32, device=dev)
    st = cuda.stream()
    cuda.launch("cc", "cc_seed_launch", cuda.ptr(m), cuda.ptr(maskp), cuda.ptr(seeds), h, w,
                ph, pw, st)

    def propagate(prev, out):
        cuda.launch("cc", "cc_propagate_launch", cuda.ptr(maskp), cuda.ptr(seeds),
                    cuda.ptr(prev), cuda.ptr(out), cuda.ptr(tmp), cuda.ptr(tmp2), cuda.ptr(flag),
                    cuda.ptr(counts), ph, pw, tile, connectivity, max_iters, st)

    def border_min(lbl):
        cuda.launch("cc", "cc_border_min_launch", cuda.ptr(maskp), cuda.ptr(lbl),
                    cuda.ptr(seeds), ph, pw, connectivity, st)

    propagate(None, other)
    border_min(other)
    propagate(other, cur)
    i = 1
    while bool(flag.item()) and i < max_outer:
        border_min(cur)
        propagate(cur, other)
        cur, other = other, cur
        i += 1
    label_components_tiled.launches += 1
    return cur[:h, :w].contiguous()


label_components_batch.launches = 0
label_components_tiled.launches = 0
