"""K2: connected components + per-pixel component sizes + dense ids.

Counterpart of the JAX package's ``ops/pallas/cc_sizes.py``
(``pallas_cc_sizes`` and ``pallas_cc_sizes_adaptive``). On a CUDA tensor
``cc_sizes`` launches ``csrc/cc_sizes.cu``; on a CPU tensor it runs
``cc_sizes_plain``. Both give, per tile: 4-connected labels (minimum
linear pixel index, INF background, the relaxation of
``ops.components.label_components``), per-pixel component sizes, dense ids
1..N of the components of size >= ``min_size`` ordered by root pixel
index, and the number of roots. Components whose root rank is >=
``s_slots`` get size 0 and dense id 0.
"""

from __future__ import annotations

import torch

from path_gene_multimodal_tpu_torch.ops import cuda
from path_gene_multimodal_tpu_torch.ops.components import label_components

MAX_ITERS = 256  # relaxation cap of the JAX package (first pass + 256)


def cc_sizes_plain(mask: torch.Tensor, s_slots: int = 4096, min_size: int = 0):
    """(B, H, W) bool → (labels, sizes, dense, n_roots), int32."""
    b, h, w = mask.shape
    mask = mask.bool()
    lbl = label_components(mask, MAX_ITERS)
    n = h * w
    flat = lbl.reshape(b, n).long()
    m = mask.reshape(b, n)
    pix = torch.arange(n, device=mask.device)
    is_root = m & (flat == pix)
    n_roots = is_root.sum(1).to(torch.int32)
    rank = torch.cumsum(is_root.int(), 1) - 1
    slot_at = torch.where(is_root & (rank < s_slots), rank, -1)
    slot = torch.where(m, slot_at.gather(1, torch.where(m, flat, 0)), -1)
    idx = torch.where(slot >= 0, slot, s_slots)
    cnt = torch.zeros((b, s_slots + 1), dtype=torch.int32, device=mask.device)
    cnt.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    cnt = cnt[:, :s_slots]
    sizes = torch.where(slot >= 0, cnt.gather(1, slot.clamp(min=0)), 0)
    exists = torch.arange(s_slots, device=mask.device) < n_roots.clamp(max=s_slots)[:, None]
    keep = ((cnt >= min_size) & exists).int()
    newrank = torch.cumsum(keep, 1) * keep
    dense = torch.where(slot >= 0, newrank.gather(1, slot.clamp(min=0)), 0)
    shape = (b, h, w)
    return (lbl, sizes.reshape(shape).int(), dense.reshape(shape).int(), n_roots)


def _launch(mask_u8, lbl, sizes, dense, n_roots, s_slots, min_size, gate, gate_slots):
    b, h, w = mask_u8.shape
    smem = cuda.size_query("cc_sizes", "cc_sizes_smem_bytes", h, w, s_slots)
    if smem > 227 * 1024:
        raise ValueError(f"cc_sizes: a {h}x{w} tile at {s_slots} slots needs {smem} B of shared memory")
    cuda.launch(
        "cc_sizes", "cc_sizes_launch",
        cuda.ptr(mask_u8), cuda.ptr(lbl), cuda.ptr(sizes), cuda.ptr(dense),
        cuda.ptr(n_roots), b, h, w, s_slots, min_size, MAX_ITERS, cuda.ptr(gate),
        gate_slots, cuda.stream(),
    )
    cc_sizes.launches += 1


def cc_sizes(mask: torch.Tensor, s_slots: int = 4096, min_size: int = 0):
    """(B, H, W) bool → (labels, sizes, dense, n_roots), int32: the CUDA
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if not mask.is_cuda:
        return cc_sizes_plain(mask, s_slots, min_size)
    lbl, sizes, dense, n_roots, mask_u8 = _outputs(mask)
    _launch(mask_u8, lbl, sizes, dense, n_roots, s_slots, min_size, None, 0)
    return lbl, sizes, dense, n_roots


def _outputs(mask: torch.Tensor):
    b, h, w = mask.shape
    if h > 1024 or w > 1024 or h * w > 65536:
        raise ValueError(f"cc_sizes kernel takes tiles of <= 65536 pixels, got {h}x{w}")
    mask_u8 = mask.contiguous().view(torch.uint8) if mask.dtype == torch.bool else (mask != 0).to(torch.uint8)
    cuda.check(mask_u8, "mask", torch.uint8, (b, h, w))
    new = lambda: torch.empty((b, h, w), dtype=torch.int32, device=mask.device)  # noqa: E731
    n_roots = torch.empty((b,), dtype=torch.int32, device=mask.device)
    return new(), new(), new(), n_roots, mask_u8


def cc_sizes_adaptive_plain(
    mask: torch.Tensor, min_size: int = 0, small: int = 512, big: int = 4096
):
    """Plain version of ``cc_sizes_adaptive`` (any device)."""
    lbl, sizes, dense, n_roots = cc_sizes_plain(mask, small, min_size)
    if bool((n_roots > small).any()):
        _, sizes, dense, _ = cc_sizes_plain(mask, big, min_size)
    return lbl, sizes, dense, n_roots > big


def cc_sizes_adaptive(
    mask: torch.Tensor, min_size: int = 0, small: int = 512, big: int = 4096
):
    """``cc_sizes`` with the JAX package's adaptive slot budget: run at
    ``small`` slots and re-run at ``big`` when any tile has more than
    ``small`` roots. Returns (labels, sizes, dense, overflow) where
    ``overflow`` (B,) bool marks tiles with more than ``big`` roots (their
    extra components get size 0).

    On the card the re-run is a second launch gated on the device by the
    first launch's root counts (its blocks return at once when no tile
    overflowed), so no value travels to the host."""
    if not mask.is_cuda:
        return cc_sizes_adaptive_plain(mask, min_size, small, big)
    lbl, sizes, dense, n_roots, mask_u8 = _outputs(mask)
    _launch(mask_u8, lbl, sizes, dense, n_roots, small, min_size, None, 0)
    # the gated launch rewrites n_roots with the same values it reads
    _launch(mask_u8, lbl, sizes, dense, n_roots, big, min_size, n_roots, small)
    return lbl, sizes, dense, n_roots > big


cc_sizes.launches = 0
