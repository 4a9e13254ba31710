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

A ``counts`` tensor (int64 (2,), on the mask's device), when given, gets
the relaxation passes of every tile added to ``counts[0]`` and the largest
pass count of one tile max-ed into ``counts[1]``, by the kernel on the card.
A pass is one row-runs-then-column-runs relaxation of the TPU kernel's
``_relax_fixpoint``, the last one (which changes nothing) included; each
relaxation that runs is counted, so the adaptive call counts its re-run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch

from path_gene_multimodal_tpu_torch.ops import cuda
from path_gene_multimodal_tpu_torch.ops.components import index_seeds, relax_fixpoint

MAX_ITERS = 256  # relaxation cap of the JAX package (first pass + 256)
MAX_PIXELS = 65_536  # uint16 pixel indices in shared memory
MAX_SIDE = 1024


@dataclass(frozen=True)
class CcSizesTiling:
    """Launch geometry of K2 (``csrc/cc_sizes.cu``) on (h, w) tiles at
    ``s_slots`` slots: one block of ``threads`` per tile. Labels are uint16
    in shared memory, rows of ``ls`` (w rounded up to 8) for 16-byte loads;
    the row runs give each lane of a warp ``per`` consecutive pixels of a
    row; the column runs give each thread a segment of ``seg_len`` rows of
    one column (``segs`` segments a column). The kernel checks what it is
    given against its own geometry."""

    threads: ClassVar[int] = 1024

    h: int
    w: int
    s_slots: int

    def __post_init__(self):
        if self.h <= 0 or self.w <= 0:
            raise ValueError(f"cc_sizes: empty tile {self.h}x{self.w}")
        if self.h > MAX_SIDE or self.w > MAX_SIDE or self.h * self.w > MAX_PIXELS:
            raise ValueError(f"cc_sizes kernel takes tiles of <= {MAX_PIXELS} pixels and "
                             f"sides <= {MAX_SIDE}, got {self.h}x{self.w}")
        if not 0 < self.s_slots < 0xFFFF:
            raise ValueError(f"cc_sizes kernel takes 1..65534 slots, got {self.s_slots}")
        if self.smem_bytes > cuda.SMEM_PER_BLOCK:
            raise ValueError(f"cc_sizes: a {self.h}x{self.w} tile at {self.s_slots} slots needs "
                             f"{self.smem_bytes} B of shared memory, more than "
                             f"{cuda.SMEM_PER_BLOCK}")

    @property
    def ls(self) -> int:
        return -(-self.w // 8) * 8

    @property
    def wpr(self) -> int:
        return -(-self.w // 32)

    @property
    def per(self) -> int:
        return 8 if self.ls <= 256 else (16 if self.ls <= 512 else 32)

    @property
    def seg_len(self) -> int:
        cols = max(1, self.threads // self.w)
        return -(-self.h // cols)

    @property
    def segs(self) -> int:
        return -(-self.h // self.seg_len)

    @property
    def smem_bytes(self) -> int:
        """Labels, mask and root bits, per-row root counts, dirty flags of
        rows and columns (two passes' worth), the segments' head/tail/full
        records, slot counts (int32) and dense ids (uint16)."""
        r16 = lambda n: -(-n // 16) * 16  # noqa: E731
        planes = self.h * self.wpr * 4
        return (self.h * self.ls * 2 + 2 * planes + self.h * 4 + r16(2 * (self.h + self.w))
                + 3 * self.threads * 4 + self.s_slots * 4 + r16(self.s_slots * 2))


def _check_counts(counts: torch.Tensor | None, device) -> None:
    if counts is None:
        return
    if counts.dtype != torch.int64 or tuple(counts.shape) != (2,) or counts.device != device:
        raise ValueError(f"counts: expected an int64 (2,) tensor on {device}, got "
                         f"{counts.dtype} {tuple(counts.shape)} on {counts.device}")


def cc_sizes_plain(mask: torch.Tensor, s_slots: int = 4096, min_size: int = 0,
                   counts: torch.Tensor | None = None):
    """(B, H, W) bool → (labels, sizes, dense, n_roots), int32."""
    _check_counts(counts, mask.device)
    b, h, w = mask.shape
    mask = mask.bool()
    lbl, passes = relax_fixpoint(mask, index_seeds(mask), 1, MAX_ITERS)
    if counts is not None:
        counts[0] += passes.sum()
        counts[1] = torch.maximum(counts[1], passes.max())
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


def _launch(mask_u8, lbl, sizes, dense, n_roots, counts, s_slots, min_size, gate, gate_slots):
    b, h, w = mask_u8.shape
    geo = CcSizesTiling(h, w, s_slots)
    cuda.launch(
        "cc_sizes", "cc_sizes_launch",
        cuda.ptr(mask_u8), cuda.ptr(lbl), cuda.ptr(sizes), cuda.ptr(dense),
        cuda.ptr(n_roots), cuda.ptr(counts), b, h, w, s_slots, min_size, MAX_ITERS,
        cuda.ptr(gate), gate_slots, geo.threads, geo.ls, geo.per, geo.seg_len, geo.smem_bytes,
        cuda.stream(mask_u8),
    )
    cc_sizes.launches += 1


def cc_sizes(mask: torch.Tensor, s_slots: int = 4096, min_size: int = 0,
             counts: torch.Tensor | None = None):
    """(B, H, W) bool → (labels, sizes, dense, n_roots), int32: the CUDA
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if not mask.is_cuda:
        return cc_sizes_plain(mask, s_slots, min_size, counts)
    lbl, sizes, dense, n_roots, mask_u8 = _outputs(mask, counts)
    _launch(mask_u8, lbl, sizes, dense, n_roots, counts, s_slots, min_size, None, 0)
    return lbl, sizes, dense, n_roots


def _outputs(mask: torch.Tensor, counts: torch.Tensor | None):
    b, h, w = mask.shape
    _check_counts(counts, mask.device)
    mask_u8 = mask.contiguous().view(torch.uint8) if mask.dtype == torch.bool else (mask != 0).to(torch.uint8)
    cuda.check(mask_u8, "mask", torch.uint8, (b, h, w))
    new = lambda: torch.empty((b, h, w), dtype=torch.int32, device=mask.device)  # noqa: E731
    n_roots = torch.empty((b,), dtype=torch.int32, device=mask.device)
    return new(), new(), new(), n_roots, mask_u8


def cc_sizes_adaptive_plain(
    mask: torch.Tensor, min_size: int = 0, small: int = 512, big: int = 4096,
    counts: torch.Tensor | None = None,
):
    """Plain version of ``cc_sizes_adaptive`` (any device)."""
    lbl, sizes, dense, n_roots = cc_sizes_plain(mask, small, min_size, counts)
    if bool((n_roots > small).any()):
        _, sizes, dense, _ = cc_sizes_plain(mask, big, min_size, counts)
    return lbl, sizes, dense, n_roots > big


def cc_sizes_adaptive(
    mask: torch.Tensor, min_size: int = 0, small: int = 512, big: int = 4096,
    counts: torch.Tensor | None = None,
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
        return cc_sizes_adaptive_plain(mask, min_size, small, big, counts)
    lbl, sizes, dense, n_roots, mask_u8 = _outputs(mask, counts)
    _launch(mask_u8, lbl, sizes, dense, n_roots, counts, small, min_size, None, 0)
    # the gated launch rewrites n_roots with the same values it reads
    _launch(mask_u8, lbl, sizes, dense, n_roots, counts, big, min_size, n_roots, small)
    return lbl, sizes, dense, n_roots > big


cc_sizes.launches = 0
