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

On the card both run one core (``csrc/cc.cu``): each tile's rows cut into
bands over a thread-block cluster, the labels in shared memory (geometry:
``CcTiling``). K5's rounds run in one cooperative launch with a grid-wide
barrier between them when every tile's cluster fits the card at once, else
one launch a round, whose "changed" flag the host reads (at most
``max_outer`` + 1 synchronisations). The geometry chooses the cluster and
the driver (``k5_plan``); the wrappers take no other.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import ClassVar

import torch

from path_gene_multimodal_tpu_torch.ops import cuda
from path_gene_multimodal_tpu_torch.ops.components import INF, index_seeds, relax_fixpoint, shift


CLUSTERS = (1, 2, 4, 8, 16)  # cluster sizes (16 is the card's non-portable largest)
MIN_BAND_ROWS = 32  # a row a warp in the row runs
MAX_SEG = 64  # rows of a column segment: its mask bits are one 64-bit word
FLAG_BYTES = 16  # the changed flag, always in shared memory


def _r16(n: int) -> int:
    return -(-n // 16) * 16


@dataclass(frozen=True)
class CcTiling:
    """Launch geometry of K5/K6 (``csrc/cc.cu``) on th x tw tiles: a tile's
    rows cut into ``n`` bands of ``bh`` rows (the last ones shorter or
    empty), one block of ``threads`` a band, the ``n`` blocks of a tile one
    thread-block cluster. A band's region holds its labels (int32, rows of
    ``ls`` = tw rounded up to 8), mask bits (``wpr`` words a row), dirty
    rows and columns, the records and mask bits of its column segments (``segs``
    segments of ``seg_len`` <= 64 rows a column, as many a column as the
    threads allow) and the copies of warp-edge columns the
    diagonal steps read; beside it lies the peer region that the other
    blocks of the cluster read (the band records and edge rows). Both live
    in shared memory when they fit (``fits``), else in a global scratch of
    ``scratch_bytes`` a block; the changed flag is always in shared memory.
    ``n`` is the smallest cluster whose band fits, or where none fits the
    largest that the tile's height allows. A launch of ``tiles`` tiles on a
    card of ``sms`` multiprocessors then doubles ``n`` while the doubled
    grid still fits the card in one wave and a band keeps at least
    ``MIN_BAND_ROWS`` rows (more blocks a tile, each relaxation shorter).
    No width is refused. The kernel checks what it is given against its
    own geometry."""

    threads: ClassVar[int] = 1024

    th: int
    tw: int
    tiles: int = 1
    sms: int = 132

    def __post_init__(self):
        if self.th <= 0 or self.tw <= 0:
            raise ValueError(f"CcTiling: empty tile {self.th}x{self.tw}")

    @functools.cached_property
    def ls(self) -> int:
        return -(-self.tw // 8) * 8

    @functools.cached_property
    def wpr(self) -> int:
        return -(-self.tw // 32)

    def _seg_len(self, bh: int) -> int:
        cols = max(1, self.threads // self.tw)
        return min(MAX_SEG, -(-bh // cols))

    def _band_bytes(self, n: int) -> int:
        bh = -(-self.th // n)
        items = -(-bh // self._seg_len(bh)) * self.tw
        return (_r16(bh * self.ls * 4) + 2 * _r16(bh * self.wpr * 4) + _r16(bh)
                + _r16(2 * self.ls) + _r16(3 * items * 4) + _r16(8 * items))

    def fits(self, n: int) -> bool:
        """Whether a band of a cluster of ``n`` and its peer region fit one
        block's shared memory."""
        return self._band_bytes(n) + self.peer_bytes + FLAG_BYTES <= cuda.SMEM_PER_BLOCK

    @functools.cached_property
    def n(self) -> int:
        fit = [n for n in CLUSTERS if self.fits(n)]
        if not fit:
            return max(n for n in CLUSTERS if n <= self.th or n == 1)
        n = fit[0]
        while (n < CLUSTERS[-1] and self.tiles * 2 * n <= self.sms
               and -(-self.th // (2 * n)) >= MIN_BAND_ROWS):
            n *= 2
        return n

    @functools.cached_property
    def bh(self) -> int:
        return -(-self.th // self.n)

    @functools.cached_property
    def seg_len(self) -> int:
        return self._seg_len(self.bh)

    @functools.cached_property
    def segs(self) -> int:
        return -(-self.bh // self.seg_len)

    @functools.cached_property
    def band_bytes(self) -> int:
        """Labels, mask bits, dirty rows, dirty columns (two relaxations'
        worth), segment records (head, tail, first background row) and mask
        bits, and warp-edge column copies of one band."""
        return self._band_bytes(self.n)

    @functools.cached_property
    def peer_bytes(self) -> int:
        """What the cluster reads of a block: band records (head, tail, all
        foreground) a column, two edge-row copies."""
        return _r16(3 * self.tw * 4) + _r16(2 * self.ls * 4)

    @functools.cached_property
    def shared(self) -> bool:
        return self.fits(self.n)

    @functools.cached_property
    def smem_bytes(self) -> int:
        return FLAG_BYTES + (self.band_bytes + self.peer_bytes if self.shared else 0)

    @functools.cached_property
    def scratch_bytes(self) -> int:
        return 0 if self.shared else self.band_bytes + self.peer_bytes

    def device_rounds(self, tiles: int, max_clusters: int) -> bool:
        """K5's driver: all rounds in one launch (grid-wide barriers) when
        the ``tiles`` clusters can all be resident at once, else a launch a
        round."""
        return tiles <= max_clusters


@functools.cache
def tiling(th: int, tw: int, tiles: int, sms: int) -> CcTiling:
    """The wrappers' geometries, built once each (a call's host time)."""
    return CcTiling(th, tw, tiles=tiles, sms=sms)


@functools.cache
def _sms(index: int) -> int:
    return cuda.sm_count(torch.device("cuda", index))


@functools.cache
def max_clusters(n: int, smem: int, shared: bool, index: int = 0) -> int:
    """Clusters of ``n`` blocks with ``smem`` bytes of shared memory each
    (their bands in shared memory or not) that card ``index`` holds at once."""
    return cuda.size_query("cc", "cc_max_clusters", torch.device("cuda", index), n, smem,
                           int(shared))


def k5_plan(h: int, w: int, tile: int, device: torch.device) -> tuple[CcTiling, bool]:
    """K5's geometry on an h x w mask cut into ``tile`` tiles on the card
    ``device``, and its driver: True runs every round in one launch (every
    tile's cluster resident at once), False a launch a round."""
    tiles = -(-h // tile) * -(-w // tile)
    index = device.index if device.index is not None else torch.cuda.current_device()
    geo = tiling(tile, tile, tiles, _sms(index))
    return geo, geo.device_rounds(tiles, max_clusters(geo.n, geo.smem_bytes, geo.shared, index))


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


def _launch(m, lbl0, lbl1, flags, bar, counts, geo: CcTiling, b, h, w, connectivity, max_iters,
            max_outer, rnd, device_rounds) -> None:
    tiles = b * -(-h // geo.th) * -(-w // geo.tw)
    scratch = (torch.empty(tiles * geo.n * geo.scratch_bytes, dtype=torch.uint8, device=m.device)
               if not geo.shared else None)
    cuda.launch("cc", "cc_label_launch", cuda.ptr(m), cuda.ptr(lbl0), cuda.ptr(lbl1),
                cuda.ptr(scratch), cuda.ptr(flags), cuda.ptr(bar), cuda.ptr(counts), b, h, w,
                geo.th, geo.tw, connectivity, max_iters, max_outer, rnd, int(device_rounds),
                geo.n, geo.bh, geo.ls, geo.seg_len, geo.segs, int(geo.shared), geo.smem_bytes,
                geo.band_bytes, cuda.stream(m))


def label_components_batch(mask: torch.Tensor, connectivity: int = 1, max_iters: int = 256,
                           counts: torch.Tensor | None = None) -> torch.Tensor:
    """K6: (B, H, W) bool → (B, H, W) int32 labels; the CUDA kernel on a
    CUDA tensor (one cluster an image, of ``CcTiling(H, W, tiles=B)``),
    the plain version on a CPU tensor."""
    if not mask.is_cuda:
        return label_components_batch_plain(mask, connectivity, max_iters, counts)
    b, h, w = mask.shape
    _check_args(connectivity, counts, mask.device)
    if h * w >= INF:
        raise ValueError(f"label_components_batch takes images of fewer than 2^30 pixels, "
                         f"got {h}x{w}")
    m = _mask_u8(mask)
    cuda.check(m, "mask", torch.uint8, (b, h, w))
    geo = tiling(h, w, b, _sms(mask.device.index or 0))
    out = torch.empty((b, h, w), dtype=torch.int32, device=mask.device)
    _launch(m, out, out, None, None, counts, geo, b, h, w, connectivity, max_iters, 0, 0, False)
    label_components_batch.launches += 1
    return out


def label_components_tiled(mask: torch.Tensor, connectivity: int = 1, tile: int = 512,
                           max_iters: int = 128, max_outer: int = 64,
                           counts: torch.Tensor | None = None) -> torch.Tensor:
    """K5: one (H, W) bool mask → (H, W) int32 labels; the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor. On the card the
    geometry and driver are ``k5_plan``'s: one launch runs every round
    (grid-wide barriers between them) where every tile's cluster fits the
    card at once, else a launch a round, whose flag the host reads."""
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
    geo, device_rounds = k5_plan(h, w, tile, dev)
    lbl = torch.empty((2, h, w), dtype=torch.int32, device=dev)
    state = torch.zeros(5, dtype=torch.int32, device=dev)  # flags [4], the grid barrier
    flags = state[:4]

    def launch(k, all_rounds=False):
        _launch(m, lbl[0], lbl[1], flags, state[4:] if all_rounds else None, counts, geo, 1, h,
                w, connectivity, max_iters, max_outer, k, all_rounds)
        label_components_tiled.launches += 1

    if device_rounds:
        launch(0, True)
        k = max(max_outer, 1)  # a round that changes nothing leaves both buffers equal
    else:
        launch(0)
        launch(1)
        k = 1
        while k < max_outer and bool(flags[k % 3].item()):
            k += 1
            launch(k)
    return lbl[k & 1]


label_components_batch.launches = 0
label_components_tiled.launches = 0
