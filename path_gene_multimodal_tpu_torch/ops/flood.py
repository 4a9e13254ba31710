"""K3: the marker watershed flood.

Counterpart of the JAX package's ``ops/pallas/flood.py``
(``pallas_marker_watershed``). On a CUDA tensor ``marker_watershed``
launches ``csrc/flood.cu``; on a CPU tensor it runs
``marker_watershed_plain``. Both follow the Pallas kernel, which is what
runs on the accelerator: per level and phase, 1 + ``max_rounds`` (= 65)
synchronous steps at most, at any number of levels >= 1. (The JAX
package's XLA flood, ``ops/watershed.py::marker_watershed``, runs 64; the
two differ wherever that cap binds.)

A ``counts`` tensor (int64 (3,), on the input's device), when given, gets
the synchronous steps of every tile added to ``counts[0]``, the largest
step count of one tile max-ed into ``counts[1]`` and the pixels grown added
to ``counts[2]``, by the kernel on the card. A step is what the Pallas
kernel counts: the first step of a phase and every step of its loop, the
last one (which changes nothing) included.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch
import torch.nn.functional as F

from path_gene_multimodal_tpu_torch.ops import cuda
from path_gene_multimodal_tpu_torch.ops.components import INF

gpu_supported = cuda.gpu_supported


@dataclass(frozen=True)
class FloodTiling:
    """Launch geometry of K3 (``csrc/flood.cu``) on (batch, h, w) tiles at
    ``levels`` levels: one block of ``threads`` per tile; the tile's state
    as ``planes`` 1-bit planes (``nq`` bit-slices of q, then mask, marker,
    labelled, U and A x 2) of ``words`` 32-bit words, row-major, ``wpr``
    words a row (bit b of word j of a row is column 32 j + b; the bits past
    w of each row's last word stay 0 in every plane). ``nq`` is 6 up to 64
    levels (the kernel's instantiation for them, the main path's), else
    the bit length of ``levels - 1`` (its instantiation that takes the
    slice count at run time, ``wide``). The planes live in shared memory
    (``smem_bytes``) when they fit in a block's, else in a global scratch
    of ``scratch_words`` words a tile (``smem_bytes`` 0). The kernel checks
    what it is given against its own geometry."""

    threads: ClassVar[int] = 1024

    h: int
    w: int
    levels: int = 64

    def __post_init__(self):
        if self.h <= 0 or self.w <= 0:
            raise ValueError(f"FloodTiling: empty tile {self.h}x{self.w}")
        if not 1 <= self.levels < 2**31:
            raise ValueError(f"FloodTiling: levels must be in 1..2^31 - 1, got {self.levels}")

    @property
    def wide(self) -> bool:
        return self.levels > 64

    @property
    def nq(self) -> int:
        return (self.levels - 1).bit_length() if self.wide else 6

    @property
    def planes(self) -> int:
        return self.nq + 6

    @property
    def wpr(self) -> int:
        return -(-self.w // 32)

    @property
    def words(self) -> int:
        return self.h * self.wpr

    @property
    def plane_bytes(self) -> int:
        return self.planes * self.words * 4

    @property
    def shared(self) -> bool:
        return self.plane_bytes <= cuda.SMEM_PER_BLOCK

    @property
    def smem_bytes(self) -> int:
        return self.plane_bytes if self.shared else 0

    @property
    def scratch_words(self) -> int:
        return 0 if self.shared else self.planes * self.words


def _neighbor_min(active: torch.Tensor) -> torch.Tensor:
    """Minimum over the 8 neighbours (INF beyond the border)."""
    h, w = active.shape[-2:]
    p = F.pad(active, (1, 1, 1, 1), value=INF)
    best = torch.full_like(active, INF)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                best = torch.minimum(best, p[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w])
    return best


def quantize(dist: torch.Tensor, levels: int) -> torch.Tensor:
    return (dist.float() * float(levels - 1)).to(torch.int32).clamp(0, levels - 1)


def _check_counts(counts: torch.Tensor | None, device) -> None:
    if counts is None:
        return
    if counts.dtype != torch.int64 or tuple(counts.shape) != (3,) or counts.device != device:
        raise ValueError(f"counts: expected an int64 (3,) tensor on {device}, got "
                         f"{counts.dtype} {tuple(counts.shape)} on {counts.device}")


def marker_watershed_plain(
    dist: torch.Tensor, markers: torch.Tensor, mask: torch.Tensor,
    levels: int = 64, max_rounds: int = 64, counts: torch.Tensor | None = None,
) -> torch.Tensor:
    """dist (B, H, W) float in [0, 1], markers (B, H, W) int32 (INF =
    unlabeled), mask (B, H, W) bool → labels (B, H, W) int32. The tiles step
    together; a tile's count stops at its own fixpoint (a step there
    changes nothing, so the extra steps leave its labels as they are)."""
    _check_counts(counts, dist.device)
    q = quantize(dist, levels)
    lbl = torch.where(markers >= INF, INF, markers).to(torch.int32)
    is_marker = lbl < INF
    mask = mask.bool()
    steps = torch.zeros(lbl.shape[0], dtype=torch.int64, device=lbl.device)

    def changed(new, old):
        return (new != old).flatten(1).any(1)

    for level in range(levels - 1, -1, -1):
        eligible = mask & (q >= level)
        fresh = is_marker & (q == level)
        for allow_fresh in (False, True):
            base = (q >= level) if allow_fresh else (q >= level) & ~fresh

            def step(l):
                active = torch.where((l < INF) & base, l, INF)
                nb = _neighbor_min(active)
                grow = eligible & (l == INF) & (nb < INF)
                return torch.where(grow, nb, l)

            new = step(lbl)
            ch = changed(new, lbl)
            steps += 1
            lbl = new
            it = 0
            while bool(ch.any()) and it < max_rounds:
                new = step(lbl)
                steps += ch
                ch = changed(new, lbl)
                lbl = new
                it += 1
    if counts is not None:
        counts[0] += steps.sum()
        counts[1] = torch.maximum(counts[1], steps.max())
        counts[2] += int((lbl < INF).sum()) - int(is_marker.sum())
    return lbl


def marker_watershed(
    dist: torch.Tensor, markers: torch.Tensor, mask: torch.Tensor,
    levels: int = 64, max_rounds: int = 64, counts: torch.Tensor | None = None,
) -> torch.Tensor:
    """The flood: the CUDA kernel on CUDA tensors (its instantiation for up
    to 64 levels, counted in ``marker_watershed.launches``, or the one that
    takes more, counted in ``WIDE_LAUNCHES``), the plain version on CPU
    tensors."""
    if not dist.is_cuda:
        return marker_watershed_plain(dist, markers, mask, levels, max_rounds, counts)
    b, h, w = dist.shape
    geo = FloodTiling(h, w, levels)
    _check_counts(counts, dist.device)
    d = dist.float().contiguous()
    mk = markers.to(torch.int32).contiguous()
    m = mask.contiguous().view(torch.uint8) if mask.dtype == torch.bool else (mask != 0).to(torch.uint8)
    cuda.check(d, "dist", torch.float32, (b, h, w))
    cuda.check(mk, "markers", torch.int32, (b, h, w))
    cuda.check(m, "mask", torch.uint8, (b, h, w))
    out = torch.empty((b, h, w), dtype=torch.int32, device=dist.device)
    scratch = (torch.empty(b * geo.scratch_words, dtype=torch.int32, device=dist.device)
               if geo.scratch_words else None)
    cuda.launch(
        "flood", "flood_launch",
        cuda.ptr(d), cuda.ptr(mk), cuda.ptr(m), cuda.ptr(out), cuda.ptr(scratch),
        cuda.ptr(counts), b, h, w, levels, max_rounds, geo.threads, geo.wpr, geo.planes,
        geo.smem_bytes, cuda.stream(d),
    )
    if geo.wide:
        WIDE_LAUNCHES.launches += 1
    else:
        marker_watershed.launches += 1
    return out


marker_watershed.launches = 0
WIDE_LAUNCHES = cuda.LaunchCount()
