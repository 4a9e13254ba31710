"""Step 1/8 — tissue segmentation + tiling, and the tile batches of the
device stages.

Counterpart of the JAX package's ``pipeline/tessellate.py`` (the
reference's Mussel wrapper, ``tiling.py:8-50``):

- ``run_tessellation``: thumbnail → tissue mask on the device (HSV
  saturation, 3×3 median, Otsu) → tile grid → per-tile foreground
  fraction (an integral image on the device) → foreground tile coords.
  Artifacts: ``<slide>.h5`` (canonical coords + attrs, through the port's
  HDF5 subset), ``mask.png``, ``grid_mask.png``, ``thumbnail.png`` and,
  optionally, per-tile ``patches/*.png``, written by ``io/png.py`` (the
  pixels of the JAX package's ``cv2.imwrite``; the bytes differ);
- ``iter_tile_batches`` and its decoders: RGB payloads, or planar 4:2:0
  payloads (Y and CbCr planes, half the bytes, padded black: Y 0, Cb = Cr
  = 128) that fall back to RGB chunk by chunk; the same prefetch thread
  pool, zero padding to the batch and ``valid`` mask.

The JAX package pads the thumbnail to one canonical shape so that one
compiled program serves every slide; the port has no compile cache to
serve and masks the thumbnail as it is (the JAX tests hold both paths
equal).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch

from path_gene_multimodal_tpu_torch.config import PipelineConfig, resolve_tile_png_name
from path_gene_multimodal_tpu_torch.core.artifacts import write_tessellation_h5
from path_gene_multimodal_tpu_torch.io.png import write_png
from path_gene_multimodal_tpu_torch.io.slide import SlideReader
from path_gene_multimodal_tpu_torch.ops import gridops, masking


@dataclass
class TessellationResult:
    coords: np.ndarray          # (N, 2) int64 level-0 top-left px, row-major
    tile_size: int
    slide_dims: tuple[int, int]  # (w, h) level 0
    mask: np.ndarray            # bool thumbnail-resolution tissue mask
    mask_scale: float           # level-0 px per mask px
    h5_path: Path | None = None

    @property
    def num_tiles(self) -> int:
        return len(self.coords)


def run_tessellation(
    slide: SlideReader,
    out_dir: str | Path,
    cfg: PipelineConfig,
    stem: str | None = None,
    write_artifacts: bool = True,
    device: str | torch.device = "cuda",
) -> TessellationResult:
    """Tessellate one slide; the mask and the tile fractions are computed
    on ``device`` (the card unless the caller passes "cpu")."""
    out_dir = Path(out_dir)
    t = cfg.tessellation
    patch = cfg.patch_size
    w0, h0 = slide.level_dimensions[0]
    stem = stem or (Path(getattr(slide, "path", "slide") or "slide").stem)

    s_canon = t.thumbnail_size
    thumb = slide.get_thumbnail((s_canon, s_canon))
    th, tw = thumb.shape[:2]
    mask_dev = masking.tissue_mask(torch.from_numpy(np.ascontiguousarray(thumb)).to(device),
                                   use_otsu=t.use_otsu, segment_threshold=t.segment_threshold)
    mask_scale = w0 / tw

    y0, y1, x0, x1, ny, nx = gridops.tile_edges_for_scale(th, tw, patch, mask_scale)
    frac = gridops.tile_foreground_fraction_edges(mask_dev, y0, y1, x0, x1)
    keep = (frac >= np.float32(t.min_foreground_frac)).cpu().numpy()
    mask = mask_dev.cpu().numpy()
    # np.nonzero on a 2-D array is row-major (y outer, x ascending within y)
    # — the reference's H5 layout
    gy, gx = np.nonzero(keep)
    coords = np.stack([gx * patch, gy * patch], axis=1).astype(np.int64)

    result = TessellationResult(
        coords=coords,
        tile_size=patch,
        slide_dims=(w0, h0),
        mask=mask,
        mask_scale=mask_scale,
    )

    if write_artifacts:
        out_dir.mkdir(parents=True, exist_ok=True)
        h5_path = out_dir / f"{stem}.h5"
        write_tessellation_h5(
            h5_path,
            coords,
            tile_size=patch,
            mpp=slide.mpp,
            extra_attrs={"slide_width": w0, "slide_height": h0},
        )
        result.h5_path = h5_path
        write_png(out_dir / "thumbnail.png", thumb)
        write_png(out_dir / "mask.png", (mask * 255).astype(np.uint8))
        write_png(out_dir / "grid_mask.png", (keep * 255).astype(np.uint8))
        if t.write_patch_pngs:
            patches_dir = out_dir / "patches"
            patches_dir.mkdir(exist_ok=True)
            for i, (x, y) in enumerate(coords):
                tile = slide.read_region((int(x), int(y)), 0, (patch, patch))
                name = resolve_tile_png_name(int(x), int(y), i, cfg.compat)
                write_png(patches_dir / name, tile)
        if not h5_path.exists():  # output-existence oracle (tiling.py:46-50)
            raise RuntimeError(f"tessellation failed to produce {h5_path}")
    return result


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
