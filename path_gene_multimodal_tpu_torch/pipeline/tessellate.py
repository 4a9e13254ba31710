"""Tile batches for the device stages.

Counterpart of ``iter_tile_batches`` and ``_decode_batch`` of the JAX
package's ``pipeline/tessellate.py`` (:142-167, :240-289): RGB payloads,
the same prefetch thread pool, zero padding to the batch and ``valid``
mask. Not ported yet: the planar 4:2:0 payloads (``planar=True``, which
come with the slide feed: the TIFF reader and the native JPEG decoder) and
``run_tessellation``.
"""

from __future__ import annotations

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


def iter_tile_batches(
    slide: SlideReader,
    coords: np.ndarray,
    tile_size: int,
    batch_size: int,
    pad_to_batch: bool = True,
    prefetch: int = 2,
    planar: bool = False,
):
    """Yield (batch_rgb_u8 (B, T, T, 3), valid_mask (B,)).

    Host decode runs in a background thread pool ``prefetch`` batches ahead
    of the consumer, so tile reads overlap device compute (the reference
    gets the same overlap from torch DataLoader workers,
    extract_embedding_from_tiles.py:16). Set ``prefetch=0`` for synchronous
    decoding. ``planar=True`` (raw 4:2:0 planes) raises
    ``NotImplementedError``: the planar feed comes with the slide feed.
    """
    if planar:
        raise NotImplementedError(
            "planar 4:2:0 tile batches are not ported yet: they come with the slide feed "
            "(the TIFF reader, the native JPEG decoder and ycbcr420_to_rgb)")
    n = len(coords)
    chunks = [coords[s : s + batch_size] for s in range(0, n, batch_size)]
    if prefetch <= 0 or len(chunks) <= 1:
        for chunk in chunks:
            yield _decode_batch(slide, chunk, tile_size, batch_size, pad_to_batch)
        return
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=prefetch) as pool:
        futures = [
            pool.submit(_decode_batch, slide, c, tile_size, batch_size, pad_to_batch)
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
                        _decode_batch, slide, chunks[next_submit], tile_size,
                        batch_size, pad_to_batch,
                    )
                )
                next_submit += 1
            yield tiles, valid
