"""Tile batches for the device stages.

Counterpart of ``iter_tile_batches``, ``_decode_batch``,
``decode_chunk_planar`` and ``_decode_batch_planar`` of the JAX package's
``pipeline/tessellate.py``: RGB payloads, or planar 4:2:0 payloads (Y and
CbCr planes, half the bytes, padded black: Y 0, Cb = Cr = 128) that fall
back to RGB chunk by chunk; the same prefetch thread pool, zero padding to
the batch and ``valid`` mask. Not ported yet: ``run_tessellation``.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from path_gene_multimodal_tpu_torch.io.slide import SlideReader


def _decode_batch(
    slide: SlideReader,
    chunk: np.ndarray,
    tile_size: int,
    batch_size: int,
    pad_to_batch: bool,
) -> tuple[np.ndarray, np.ndarray]:
    # a reader with a batched fast path pre-decodes exactly the tiles this
    # chunk touches (populates its cache)
    prefetch_regions = getattr(slide, "prefetch_regions", None)
    if prefetch_regions is not None and len(chunk):
        prefetch_regions(chunk, 0, (tile_size, tile_size))
    tiles = np.stack(
        [
            slide.read_region((int(x), int(y)), 0, (tile_size, tile_size))
            for x, y in chunk
        ]
    )
    valid = np.ones(len(chunk), dtype=bool)
    if pad_to_batch and len(chunk) < batch_size:
        pad = batch_size - len(chunk)
        tiles = np.concatenate(
            [tiles, np.zeros((pad, tile_size, tile_size, 3), np.uint8)]
        )
        valid = np.concatenate([valid, np.zeros(pad, dtype=bool)])
    return tiles, valid


def decode_chunk_planar(
    slide: SlideReader,
    chunk: np.ndarray,
    tile_size: int,
    batch_size: int | None = None,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Planar 4:2:0 decode of a chunk of tiles, shared by the embed and
    nuclei feeds: (Y (B, T, T), CbCr (B, T/2, T/2, 2)) uint8, padded up to
    ``batch_size`` with black (Y 0, Cb = Cr = 128, the planar counterpart
    of the RGB zero pad); or None when any region of the chunk cannot be
    served planar (odd coordinates or size, a tile that is not 4:2:0, a
    reader without planar reads), and the caller decodes the chunk as RGB."""
    chunk = np.asarray(chunk).reshape(-1, 2)
    rrp = getattr(slide, "read_region_planar", None)
    if rrp is None or len(chunk) == 0 or tile_size % 2 or bool(np.any(chunk % 2)):
        return None
    pre = getattr(slide, "prefetch_regions_planar", None)
    if pre is not None:
        pre(chunk, 0, (tile_size, tile_size))
    ys, cs = [], []
    for x, y in chunk:
        planes = rrp((int(x), int(y)), 0, (tile_size, tile_size))
        if planes is None:
            return None
        ys.append(planes[0])
        cs.append(planes[1])
    yb, cb = np.stack(ys), np.stack(cs)
    if batch_size is not None and len(chunk) < batch_size:
        pad = batch_size - len(chunk)
        yb = np.concatenate([yb, np.zeros((pad, tile_size, tile_size), np.uint8)])
        cb = np.concatenate(
            [cb, np.full((pad, tile_size // 2, tile_size // 2, 2), 128, np.uint8)])
    return yb, cb


def _decode_batch_planar(
    slide: SlideReader,
    chunk: np.ndarray,
    tile_size: int,
    batch_size: int,
    pad_to_batch: bool,
) -> tuple[Any, np.ndarray]:
    """((Y, CbCr), valid), or the RGB decode's (tiles, valid) for a chunk
    the planar path cannot serve: consumers tell them apart by type (a
    tuple of planes, or one RGB array)."""
    planes = decode_chunk_planar(slide, chunk, tile_size, batch_size if pad_to_batch else None)
    if planes is None:
        return _decode_batch(slide, chunk, tile_size, batch_size, pad_to_batch)
    valid = np.ones(len(chunk), dtype=bool)
    if pad_to_batch and len(chunk) < batch_size:
        valid = np.concatenate([valid, np.zeros(batch_size - len(chunk), dtype=bool)])
    return planes, valid


def iter_tile_batches(
    slide: SlideReader,
    coords: np.ndarray,
    tile_size: int,
    batch_size: int,
    pad_to_batch: bool = True,
    prefetch: int = 2,
    planar: bool = False,
):
    """Yield (batch_rgb_u8 (B, T, T, 3), valid_mask (B,)); with
    ``planar=True``, ((Y (B, T, T), CbCr (B, T/2, T/2, 2)), valid_mask):
    raw 4:2:0 planes, half the host-to-device bytes, which
    ``ops.jpegcolor.ycbcr420_to_rgb`` finishes on the device. A chunk the
    planar path cannot serve (odd coordinates, a tile that is not 4:2:0)
    comes as the RGB array instead: planar consumers check
    ``isinstance(payload, tuple)``.

    Host decode runs in a background thread pool ``prefetch`` batches ahead
    of the consumer, so tile reads overlap device compute (the reference
    gets the same overlap from torch DataLoader workers,
    extract_embedding_from_tiles.py:16). Set ``prefetch=0`` for synchronous
    decoding.
    """
    decode = _decode_batch_planar if planar else _decode_batch
    n = len(coords)
    chunks = [coords[s : s + batch_size] for s in range(0, n, batch_size)]
    if prefetch <= 0 or len(chunks) <= 1:
        for chunk in chunks:
            yield decode(slide, chunk, tile_size, batch_size, pad_to_batch)
        return
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=prefetch) as pool:
        futures = [
            pool.submit(decode, slide, c, tile_size, batch_size, pad_to_batch)
            for c in chunks[: prefetch + 1]
        ]
        next_submit = prefetch + 1
        for i in range(len(chunks)):
            tiles, valid = futures[i].result()
            futures[i] = None  # release the decoded stack — retaining every
            # batch across a 100k-tile slide would hold GBs on the host
            if next_submit < len(chunks):
                futures.append(
                    pool.submit(
                        decode, slide, chunks[next_submit], tile_size,
                        batch_size, pad_to_batch,
                    )
                )
                next_submit += 1
            yield tiles, valid
