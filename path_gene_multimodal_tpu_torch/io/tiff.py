"""Tiled TIFF / Aperio SVS reader: an IFD parser and per-tile decode.

A copy of the JAX package's ``io/tiff.py`` (``TiffTileSlide`` and its
helpers: classic and BigTIFF IFDs, tiled and striped pages, associated
images, the MPP parse, LZW / PackBits / predictor 2, the shared RGB/planar
LRU with its byte budget, the planar 4:2:0 reads). Per tile:

- JPEG (compression 7, with Aperio's shared ``JPEGTables``, tag 347)
  through the port's own decoder (``io/native.py``, ``csrc/tiledecode.cpp``),
  in threaded batches where it can. A tile that decoder refuses
  (progressive, arithmetic-coded, 12-bit, CMYK, ... see
  ``io.native.REFUSALS``) is decoded by PIL, which gives the pixels the JAX
  package's cv2 route gives; the reader counts such tiles in
  ``decoder_refusals`` (by reason in ``decoder_refusal_reasons``);
- Deflate/AdobeDeflate (8, 32946) through zlib;
- PackBits (32773), LZW (5) and raw (1) in numpy;
- JPEG2000 (33003/33005/34712) through PIL, where the JAX package uses cv2.

``read_region`` assembles any rectangle from the tile grid, decoding only
the covered tiles: level-0 locations, openslide semantics.
"""

from __future__ import annotations

import struct
import zlib
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Any, BinaryIO

import numpy as np

from path_gene_multimodal_tpu_torch.io.native import REFUSALS

# TIFF tag ids we care about
_TAG_IMAGE_WIDTH = 256
_TAG_IMAGE_LENGTH = 257
_TAG_BITS_PER_SAMPLE = 258
_TAG_COMPRESSION = 259
_TAG_PHOTOMETRIC = 262
_TAG_IMAGE_DESCRIPTION = 270
_TAG_STRIP_OFFSETS = 273
_TAG_SAMPLES_PER_PIXEL = 277
_TAG_ROWS_PER_STRIP = 278
_TAG_STRIP_BYTE_COUNTS = 279
_TAG_X_RESOLUTION = 282
_TAG_PLANAR_CONFIG = 284
_TAG_RESOLUTION_UNIT = 296
_TAG_TILE_WIDTH = 322
_TAG_TILE_LENGTH = 323
_TAG_TILE_OFFSETS = 324
_TAG_TILE_BYTE_COUNTS = 325
_TAG_PREDICTOR = 317
_TAG_JPEG_TABLES = 347

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d", 16: "Q", 17: "q"}


@dataclass
class TiffPage:
    width: int
    height: int
    tile_width: int | None
    tile_height: int | None
    compression: int
    photometric: int
    samples: int
    offsets: np.ndarray
    byte_counts: np.ndarray
    rows_per_strip: int | None
    jpeg_tables: bytes | None
    predictor: int = 1  # TIFF tag 317: 2 = horizontal byte differencing
    description: str = ""
    x_resolution: float | None = None
    resolution_unit: int | None = None
    bits_per_sample: int = 8  # TIFF tag 258 (first sample)
    planar_config: int = 1  # TIFF tag 284: 2 = separate sample planes
    # striped page modeled as full-width degenerate tiles (tile_width =
    # image width, tile_height = RowsPerStrip, tiles_across = 1) so the
    # read_region/LRU machinery applies unchanged; the last strip decodes
    # short (real writers emit only the remaining rows)
    is_strips: bool = False

    @property
    def is_tiled(self) -> bool:
        return self.tile_width is not None

    @property
    def tiles_across(self) -> int:
        assert self.tile_width
        return (self.width + self.tile_width - 1) // self.tile_width

    @property
    def tiles_down(self) -> int:
        assert self.tile_height
        return (self.height + self.tile_height - 1) // self.tile_height


def _read_ifds(f: BinaryIO) -> tuple[list[dict[int, object]], str]:
    f.seek(0, 2)
    fsize = f.tell()
    f.seek(0)
    header = f.read(8)
    if header[:2] == b"II":
        endian = "<"
    elif header[:2] == b"MM":
        endian = ">"
    else:
        raise ValueError("not a TIFF file")
    magic = struct.unpack(endian + "H", header[2:4])[0]
    bigtiff = magic == 43
    if bigtiff:
        f.seek(8)
        offset = struct.unpack(endian + "Q", f.read(8))[0]
        entry_size, count_fmt, off_fmt = 20, "Q", "Q"
    elif magic == 42:
        offset = struct.unpack(endian + "I", header[4:8])[0]
        entry_size, count_fmt, off_fmt = 12, "H", "I"
    else:
        raise ValueError(f"bad TIFF magic {magic}")

    ifds: list[dict[int, object]] = []
    seen_offsets: set[int] = set()
    while offset:
        # fail closed on corrupt files: a next-IFD pointer that revisits an
        # offset is a cycle (would loop forever); >4096 IFDs is garbage
        # (real SVS pyramids have ~4-10 pages)
        if offset in seen_offsets:
            raise ValueError(f"TIFF IFD chain cycles back to offset {offset}")
        seen_offsets.add(offset)
        if len(seen_offsets) > 4096:
            raise ValueError("TIFF IFD chain exceeds 4096 pages; corrupt file")
        f.seek(offset)
        n = struct.unpack(endian + count_fmt, f.read(struct.calcsize(count_fmt)))[0]
        raw = f.read(n * entry_size)
        entries: dict[int, tuple[int, int, bytes]] = {}
        for i in range(n):
            e = raw[i * entry_size : (i + 1) * entry_size]
            tag, typ = struct.unpack(endian + "HH", e[:4])
            if bigtiff:
                cnt = struct.unpack(endian + "Q", e[4:12])[0]
                val = e[12:20]
            else:
                cnt = struct.unpack(endian + "I", e[4:8])[0]
                val = e[8:12]
            entries[tag] = (typ, cnt, val)
        next_off_raw = f.read(struct.calcsize(off_fmt))
        offset = struct.unpack(endian + off_fmt, next_off_raw)[0]

        # resolve values
        resolved: dict[int, object] = {}
        inline_size = 8 if bigtiff else 4
        for tag, (typ, cnt, val) in entries.items():
            size = _TYPE_SIZES.get(typ, 1) * cnt
            if size > fsize:
                # fail closed: a corrupt count would otherwise ask read()
                # for gigabytes that cannot exist in this file
                raise ValueError(
                    f"TIFF tag {tag} claims {size} value bytes in a "
                    f"{fsize}-byte file; corrupt"
                )
            if size > inline_size:
                ptr = struct.unpack(endian + ("Q" if bigtiff else "I"), val[: 8 if bigtiff else 4])[0]
                f.seek(ptr)
                data = f.read(size)
            else:
                data = val[:size]
            if typ == 2:  # ASCII
                resolved[tag] = data.split(b"\0")[0].decode("latin-1", "replace")
            elif typ in (5, 10):  # rational
                fmt = "I" if typ == 5 else "i"
                vals = struct.unpack(endian + fmt * (2 * cnt), data)
                resolved[tag] = [
                    (vals[2 * i] / vals[2 * i + 1]) if vals[2 * i + 1] else 0.0
                    for i in range(cnt)
                ]
            elif typ in (7,):  # undefined bytes
                resolved[tag] = data
            elif typ in _TYPE_FMT:
                fmt = _TYPE_FMT[typ]
                resolved[tag] = list(struct.unpack(endian + fmt * cnt, data))
            else:
                resolved[tag] = data
        ifds.append(resolved)
    return ifds, endian


def _scalar(ifd: dict, tag: int, default=None):
    v = ifd.get(tag, default)
    if isinstance(v, list):
        return v[0] if v else default
    return v


def _page_from_ifd(ifd: dict) -> TiffPage | None:
    width = _scalar(ifd, _TAG_IMAGE_WIDTH)
    height = _scalar(ifd, _TAG_IMAGE_LENGTH)
    if width is None or height is None:
        return None
    if not (0 < int(width) < 2**32 and 0 < int(height) < 2**32):
        return None  # corrupt dims — drop the page (fail-closed)
    tiled = _TAG_TILE_OFFSETS in ifd
    strip_tw = strip_th = None
    if tiled:
        tw, th = _scalar(ifd, _TAG_TILE_WIDTH), _scalar(ifd, _TAG_TILE_LENGTH)
        # sane tile bounds: TIFF tiles are small fixed blocks (SVS 240-512,
        # Ventana ≤4096). A corrupt TileWidth of 0 would divide-by-zero in
        # the grid math; a huge claim would drive multi-GB per-tile decode
        # allocations. 16..16384 per side, ≤4096² area.
        if tw is None or th is None:
            return None
        if not (16 <= int(tw) <= 16384 and 16 <= int(th) <= 16384):
            return None
        if int(tw) * int(th) > 4096 * 4096:
            return None
    elif _TAG_STRIP_OFFSETS in ifd:
        # striped page → full-width degenerate tiles. Bound the per-strip
        # decode at 2²⁶ px (≈ 200 MB RGB — generous enough for a 140k-px-
        # wide libvips base level at RowsPerStrip≈128, but a missing
        # RowsPerStrip on a gigapixel page means one whole-image strip and
        # is rejected). Warn rather than drop silently: losing a BASE page
        # would serve a downsampled level as level 0.
        rps = _scalar(ifd, _TAG_ROWS_PER_STRIP)
        rps = int(rps) if rps else int(height)
        rps = min(rps, int(height))
        if rps < 1 or int(width) * rps > 1 << 26:
            from path_gene_multimodal_tpu_torch.utils.log import get_logger

            get_logger().warning(
                "dropping striped TIFF page %dx%d: strip of %d rows = %d px "
                "exceeds the %d-px decode bound", width, height, rps,
                int(width) * max(rps, 0), 1 << 26,
            )
            return None
        strip_tw, strip_th = int(width), rps
    offsets = np.asarray(
        ifd.get(_TAG_TILE_OFFSETS if tiled else _TAG_STRIP_OFFSETS, []), dtype=np.int64
    )
    counts = np.asarray(
        ifd.get(_TAG_TILE_BYTE_COUNTS if tiled else _TAG_STRIP_BYTE_COUNTS, []),
        dtype=np.int64,
    )
    jt = ifd.get(_TAG_JPEG_TABLES)
    return TiffPage(
        width=int(width),
        height=int(height),
        tile_width=int(_scalar(ifd, _TAG_TILE_WIDTH)) if tiled else strip_tw,
        tile_height=int(_scalar(ifd, _TAG_TILE_LENGTH)) if tiled else strip_th,
        compression=int(_scalar(ifd, _TAG_COMPRESSION, 1)),
        photometric=int(_scalar(ifd, _TAG_PHOTOMETRIC, 2)),
        samples=int(_scalar(ifd, _TAG_SAMPLES_PER_PIXEL, 3)),
        offsets=offsets,
        byte_counts=counts,
        rows_per_strip=int(_scalar(ifd, _TAG_ROWS_PER_STRIP)) if _TAG_ROWS_PER_STRIP in ifd else None,
        is_strips=strip_tw is not None,
        planar_config=int(_scalar(ifd, _TAG_PLANAR_CONFIG, 1)),
        jpeg_tables=bytes(jt) if isinstance(jt, (bytes, bytearray)) else None,
        predictor=int(_scalar(ifd, _TAG_PREDICTOR, 1)),
        description=str(ifd.get(_TAG_IMAGE_DESCRIPTION, "")),
        x_resolution=float(_scalar(ifd, _TAG_X_RESOLUTION)) if _TAG_X_RESOLUTION in ifd else None,
        resolution_unit=int(_scalar(ifd, _TAG_RESOLUTION_UNIT)) if _TAG_RESOLUTION_UNIT in ifd else None,
        bits_per_sample=int(_scalar(ifd, _TAG_BITS_PER_SAMPLE, 8)),
    )


def _lzw_decode(data: bytes) -> bytes:
    """TIFF-variant LZW (MSB-first codes, EarlyChange=1)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table: list[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    bitbuf = bitcnt = 0
    width = 9
    prev: bytes | None = None
    for byte in data:
        bitbuf = (bitbuf << 8) | byte
        bitcnt += 8
        while bitcnt >= width:
            code = (bitbuf >> (bitcnt - width)) & ((1 << width) - 1)
            bitcnt -= width
            if code == CLEAR:
                table = table[:258]
                width = 9
                prev = None
                continue
            if code == EOI:
                return bytes(out)
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            else:
                entry = prev + prev[:1]
                table.append(entry)
            out += entry
            prev = entry
            if len(table) + 1 >= (1 << width) and width < 12:
                width += 1
    return bytes(out)


def _packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        i += 1
        if b < 128:
            out += data[i : i + b + 1]
            i += b + 1
        elif b > 128:
            if i < n:
                out += bytes([data[i]]) * (257 - b)
                i += 1
    return bytes(out)


_THUMB_ONESHOT_BYTES = 1 << 28  # 256 MB: above this, thumbnail in bands


class TiffTileSlide:
    """Pyramidal reader over a tiled TIFF/SVS file."""

    def __init__(self, path: str | Path, cache_tiles: int = 512):
        self.path = Path(path)
        self._f = open(self.path, "rb")
        self._fsize = self.path.stat().st_size
        # decoded-tile LRU: a 224-px grid read touches up to four 256-px
        # TIFF tiles, so neighboring reads re-decode the same tiles ~4×
        # without it. Budgeted in BYTES (cache_tiles × one 256² RGB tile ≈
        # 100 MB at the default) as well as entries: striped pages decode
        # full-width strips that can be tens of MB each, so an entry-only
        # cap would balloon to multi-GB.
        from collections import OrderedDict
        from threading import Lock

        # one LRU for both entry kinds — ("rgb", level, idx) → HxWx3 array,
        # ("p", level, idx) → (Y, CbCr) planes for the half-bandwidth device
        # feed — sharing a single budget so mixed RGB/planar use stays
        # under the same ceiling (planar entries are half the bytes)
        self._cache: OrderedDict[tuple[str, int, int], Any] = OrderedDict()
        self._cache_cap = cache_tiles
        self._cache_bytes_cap = cache_tiles * 256 * 256 * 3
        self._cache_bytes = 0
        self._cache_lock = Lock()
        ifds, self._endian = _read_ifds(self._f)
        pages = [p for p in (_page_from_ifd(i) for i in ifds) if p is not None]
        # pyramid = tiled pages sorted by width desc (SVS: page 0 base, then
        # thumbnail (stripped), then pyramid levels, label, macro). Striped
        # pages back the pyramid ONLY when the file has no truly tiled
        # pages (libvips/CAMELYON-style striped pyramids, plain tifffile
        # saves) — in an SVS they are associated images, never levels.
        tiled = [p for p in pages if p.is_tiled and not p.is_strips]
        strip_backed = not tiled
        if not tiled:
            tiled = [p for p in pages if p.is_tiled]  # strip-backed pages
        if not tiled:
            raise ValueError(f"{path}: no tiled or striped pages")
        base = max(tiled, key=lambda p: p.width)
        self._pages = sorted(
            (p for p in tiled if _is_pyramid_level(p, base.width, base.height)),
            key=lambda p: -p.width,
        )
        if strip_backed:
            # validate decodability UP FRONT: open_slide's whole-image (PIL)
            # fallback only triggers on constructor failure, and striped
            # files with layouts this reader rejects (16-bit, palette,
            # separate planes, unknown codecs) previously reached that
            # fallback via the old "no tiled pages" error — raising here
            # preserves it instead of crashing at first read_region
            for p in self._pages:
                err = _page_decode_unsupported(p)
                if err:
                    raise ValueError(f"{path}: striped page unsupported: {err}")
        # non-pyramid pages = associated images (openslide/tiffslide
        # surface: SVS thumbnail/label/macro). Named from the Aperio page
        # description when it says so, else positionally.
        in_pyramid = {id(p) for p in self._pages}
        self._associated_pages: dict[str, TiffPage] = {}
        n_anon = 0
        for p in pages:
            if (
                id(p) in in_pyramid
                or not p.is_tiled  # no readable chunk geometry
                or _page_decode_unsupported(p)
                or p.width * p.height > 1 << 26  # decoded whole; bound it
            ):
                continue
            desc = (p.description or "").lower()
            if "label" in desc:
                name = "label"
            elif "macro" in desc:
                name = "macro"
            elif n_anon == 0:
                name = "thumbnail"  # Aperio: first associated page
            else:
                name = f"associated_{n_anon}"
            if name in self._associated_pages:
                name = f"{name}_{n_anon}"
            n_anon += 1
            self._associated_pages[name] = p
        self._mpp = _parse_mpp(self._pages[0])
        # the port's decoder always serves JPEG pages; a failed build raises
        from path_gene_multimodal_tpu_torch.io.native import NativeTileDecoder

        self._native = NativeTileDecoder()
        self.decoder_refusals = 0
        self.decoder_refusal_reasons: Counter[str] = Counter()

    # -- SlideReader surface --------------------------------------------------

    @property
    def level_dimensions(self) -> list[tuple[int, int]]:
        return [(p.width, p.height) for p in self._pages]

    @property
    def level_downsamples(self) -> list[float]:
        w0 = self._pages[0].width
        return [w0 / p.width for p in self._pages]

    @property
    def mpp(self) -> float | None:
        return self._mpp

    def read_region(
        self, location: tuple[int, int], level: int, size: tuple[int, int]
    ) -> np.ndarray:
        x0_l0, y0_l0 = location
        w, h = size
        ds = self.level_downsamples[level]
        x0, y0 = int(round(x0_l0 / ds)), int(round(y0_l0 / ds))
        page = self._pages[level]
        out = np.full((h, w, 3), 255, dtype=np.uint8)
        tw, th = page.tile_width, page.tile_height
        tx0, tx1, ty0, ty1 = _tile_cover(page, x0, y0, w, h)
        for ty in range(ty0, ty1 + 1):
            for tx in range(tx0, tx1 + 1):
                tile = self._decode_tile_cached(level, page, ty * page.tiles_across + tx)
                if tile is None:
                    continue
                gx, gy = tx * tw, ty * th  # tile origin in level px
                sy0, sy1 = max(y0 - gy, 0), min(y0 + h - gy, tile.shape[0])
                sx0, sx1 = max(x0 - gx, 0), min(x0 + w - gx, tile.shape[1])
                if sy1 <= sy0 or sx1 <= sx0:
                    continue
                out[gy + sy0 - y0 : gy + sy1 - y0, gx + sx0 - x0 : gx + sx1 - x0] = tile[
                    sy0:sy1, sx0:sx1, :3
                ]
        return out

    def get_thumbnail(self, max_size: tuple[int, int]) -> np.ndarray:
        """The best level for the scale, area-resized (``resize_area``, the
        port's ``cv2.INTER_AREA``) in one piece, or in horizontal bands
        when the level is over ``_THUMB_ONESHOT_BYTES``."""
        from path_gene_multimodal_tpu_torch.io.slide import resize_area

        tw_max, th_max = max_size
        w0, h0 = self.level_dimensions[0]
        scale = min(tw_max / w0, th_max / h0, 1.0)
        level = self.get_best_level_for_downsample(1.0 / scale if scale < 1 else 1.0)
        pw, ph = self.level_dimensions[level]
        out_w, out_h = max(int(w0 * scale), 1), max(int(h0 * scale), 1)
        ds = self.level_downsamples[level]
        if pw * ph * 3 <= _THUMB_ONESHOT_BYTES:  # small: one read + resize
            full = self.read_region((0, 0), level, (pw, ph))
            return resize_area(full, out_w, out_h)
        # band-wise: a single-level WSI (no pyramid to downsample from)
        # would otherwise materialize the whole multi-GB base image here.
        # Read horizontal bands, resize each to its slice of the output —
        # memory stays bounded by one band regardless of slide size.
        band_rows = max(_THUMB_ONESHOT_BYTES // (pw * 3), 256)
        out = np.empty((out_h, out_w, 3), np.uint8)
        for y in range(0, ph, band_rows):
            rows = min(band_rows, ph - y)
            band = self.read_region((0, int(round(y * ds))), level, (pw, rows))
            oy0 = int(round(y * out_h / ph))
            oy1 = int(round((y + rows) * out_h / ph))
            if oy1 <= oy0:
                continue
            out[oy0:oy1] = resize_area(band, out_w, oy1 - oy0)
        return out

    def get_best_level_for_downsample(self, downsample: float) -> int:
        from path_gene_multimodal_tpu_torch.io.slide import best_level_for_downsample

        return best_level_for_downsample(self.level_downsamples, downsample)

    @property
    def associated_image_names(self) -> list[str]:
        """Names of the non-pyramid pages (openslide/tiffslide surface:
        SVS ``thumbnail``/``label``/``macro``)."""
        return list(self._associated_pages)

    def read_associated_image(self, name: str) -> np.ndarray:
        """Decode one associated image in full (they are small — pages
        over 2²⁶ px are never classified as associated). Uncached: these
        are one-shot reads, not tile-loop traffic."""
        page = self._associated_pages[name]
        out = np.full((page.height, page.width, 3), 255, np.uint8)
        tw, th = page.tile_width, page.tile_height
        for ty in range(page.tiles_down):
            for tx in range(page.tiles_across):
                tile = self._decode_tile(page, ty * page.tiles_across + tx)
                if tile is None:
                    continue
                gy, gx = ty * th, tx * tw
                sh = min(tile.shape[0], page.height - gy)
                sw = min(tile.shape[1], page.width - gx)
                out[gy : gy + sh, gx : gx + sw] = tile[:sh, :sw, :3]
        return out

    @property
    def associated_images(self) -> dict[str, np.ndarray]:
        """All associated images decoded — openslide-style mapping."""
        return {n: self.read_associated_image(n) for n in self._associated_pages}

    # -- decoding -------------------------------------------------------------

    def read_tiles_batch(self, level: int, tile_ids: np.ndarray) -> np.ndarray:
        """Decode a batch of tiles (by linear tile id) — the fast path used by
        tessellation; dispatches to the C++ threaded decoder when available."""
        page = self._pages[level]
        has_sparse = any(
            int(t) < 0 or int(t) >= len(page.offsets)
            or page.byte_counts[int(t)] == 0 or page.offsets[int(t)] == 0
            for t in tile_ids
        )
        batch = status = None
        if page.compression == 7 and not has_sparse and not page.is_strips:
            # strips excluded: the batch decoder assumes one fixed tile
            # geometry, but the last strip is shorter
            blobs = [self._tile_bytes(page, int(tid)) for tid in tile_ids]
            (batch,), status = self._native.decode_jpeg_status(
                blobs, page.tile_height, page.tile_width, page.jpeg_tables
            )
            if not status.any():
                return batch
        tiles = []
        for j, t in enumerate(tile_ids):
            if status is not None and status[j] == 0:
                tiles.append(batch[j])
                continue
            tile = self._decode_tile(page, int(t))
            if tile is None:  # sparse-tile convention → blank (white)
                tile = np.full(
                    (page.tile_height, page.tile_width, 3), 255, np.uint8
                )
            elif tile.shape[:2] != (page.tile_height, page.tile_width):
                # short last strip (or undersized edge tile): white-pad to
                # the declared geometry so the batch stacks
                pad = np.full((page.tile_height, page.tile_width, 3), 255, np.uint8)
                pad[: tile.shape[0], : tile.shape[1]] = tile[
                    : page.tile_height, : page.tile_width, :3
                ]
                tile = pad
            tiles.append(tile)
        return np.stack(tiles)

    def prefetch_regions(
        self,
        locations: "np.ndarray",
        level: int,
        size: tuple[int, int],
    ) -> int:
        """Batch-decode exactly the TIFF tiles covered by the given regions
        (N×2 level-0 top-left coords, common ``size``) into the LRU cache
        using the native C++ thread-pool decoder (JPEG pages only; no-op
        otherwise). Exact per-region coverage — a bounding box over a
        row-major chunk would decode ~3× too many tiles and thrash the
        cache. Returns the number of tiles decoded."""
        page = self._pages[level]
        if (
            self._cache_cap <= 0  # nowhere to keep the decoded tiles
            or page.compression != 7
            or not page.is_tiled
            or page.is_strips
        ):
            return 0
        ids = self._region_tile_ids(page, level, locations, size)
        with self._cache_lock:
            missing = [
                i for i in ids
                if ("rgb", level, i) not in self._cache
                and page.byte_counts[i] > 0 and page.offsets[i] > 0
            ]
        if not missing:
            return 0
        blobs = [self._tile_bytes(page, i) for i in missing]
        (arr,), status = self._native.decode_jpeg_status(
            blobs, page.tile_height, page.tile_width, page.jpeg_tables
        )
        # a refused tile stays out of the cache: read_region decodes it
        # alone (through PIL, counted)
        with self._cache_lock:
            for j, i in enumerate(missing):
                if status[j] == 0:
                    self._cache_put_locked(("rgb", level, i), arr[j])
        return int((status == 0).sum())

    # -- planar (4:2:0) fast path --------------------------------------------
    # Ships JPEG tiles to the device as raw Y + CbCr planes (half the bytes
    # of RGB); chroma upsample + color conversion finish on device
    # (ops/jpegcolor.ycbcr420_to_rgb). See csrc/tiledecode.cpp.

    def supports_planar(self, level: int = 0) -> bool:
        """True if this level can serve raw 4:2:0 planes: JPEG compression,
        even tile geometry, and the first non-empty tile actually decodes
        as plain 4:2:0 YCbCr."""
        page = self._pages[level]
        if (
            page.compression != 7
            or not page.is_tiled
            or page.is_strips
            or page.tile_width % 2
            or page.tile_height % 2
        ):
            return False
        for idx in range(len(page.offsets)):
            if page.byte_counts[idx] > 0 and page.offsets[idx] > 0:
                return (
                    self._decode_tile_planar_cached(level, page, idx)
                    is not None
                )
        return False

    def prefetch_regions_planar(
        self, locations: "np.ndarray", level: int, size: tuple[int, int]
    ) -> int:
        """Planar analog of :meth:`prefetch_regions` — batch-decodes the
        covered TIFF tiles into the planar LRU cache."""
        page = self._pages[level]
        if (
            self._cache_cap <= 0
            or page.compression != 7
            or not page.is_tiled
            or page.is_strips
        ):
            return 0
        ids = self._region_tile_ids(page, level, locations, size)
        with self._cache_lock:
            missing = [
                i for i in ids
                if ("p", level, i) not in self._cache
                and page.byte_counts[i] > 0 and page.offsets[i] > 0
            ]
        if not missing:
            return 0
        blobs = [self._tile_bytes(page, i) for i in missing]
        ys, cbcrs, ok = self._native.decode_jpeg_batch_planar(
            blobs, page.tile_height, page.tile_width, page.jpeg_tables,
            return_ok=True,
        )
        with self._cache_lock:
            for j, i in enumerate(missing):
                # failures are memoized as a None sentinel so later
                # read_region_planar calls short-circuit to the RGB
                # fallback instead of re-decoding the bad tile every chunk
                self._cache_put_locked(
                    ("p", level, i), (ys[j], cbcrs[j]) if ok[j] else None
                )
        return int(ok.sum())

    def read_region_planar(
        self, location: tuple[int, int], level: int, size: tuple[int, int]
    ) -> tuple[np.ndarray, np.ndarray] | None:
        """Assemble a region as raw planes: (Y (h,w), CbCr (h/2,w/2,2))
        uint8. Returns None when the planar path cannot serve it (odd
        geometry, non-JPEG page, non-4:2:0 tile) — caller falls back to
        :meth:`read_region`. Requires even location/size so the plane crops
        commute with the 2×2 chroma layout (nearest upsample is local)."""
        x0_l0, y0_l0 = location
        w, h = size
        ds = self.level_downsamples[level]
        x0, y0 = int(round(x0_l0 / ds)), int(round(y0_l0 / ds))
        page = self._pages[level]
        if (
            page.compression != 7
            or not page.is_tiled
            or page.is_strips
            or (x0 % 2) or (y0 % 2) or (w % 2) or (h % 2)
            or page.tile_width % 2
            or page.tile_height % 2
        ):
            return None
        out_y = np.full((h, w), 255, dtype=np.uint8)
        out_c = np.full((h // 2, w // 2, 2), 128, dtype=np.uint8)
        tw, th = page.tile_width, page.tile_height
        tx0, tx1, ty0, ty1 = _tile_cover(page, x0, y0, w, h)
        for ty in range(ty0, ty1 + 1):
            for tx in range(tx0, tx1 + 1):
                idx = ty * page.tiles_across + tx
                if (
                    idx >= len(page.offsets)  # truncated offsets tag
                    or page.byte_counts[idx] == 0 or page.offsets[idx] == 0
                ):
                    continue  # sparse tile: stays white
                planes = self._decode_tile_planar_cached(level, page, idx)
                if planes is None:
                    return None  # not 4:2:0 — whole region falls back
                ptile_y, ptile_c = planes
                gx, gy = tx * tw, ty * th
                sy0, sy1 = max(y0 - gy, 0), min(y0 + h - gy, th)
                sx0, sx1 = max(x0 - gx, 0), min(x0 + w - gx, tw)
                if sy1 <= sy0 or sx1 <= sx0:
                    continue
                oy, ox = gy + sy0 - y0, gx + sx0 - x0
                out_y[oy : oy + (sy1 - sy0), ox : ox + (sx1 - sx0)] = ptile_y[
                    sy0:sy1, sx0:sx1
                ]
                # tile origins are multiples of the (even) tile size and the
                # region origin is even, so every crop offset here is even
                out_c[
                    oy // 2 : (oy + sy1 - sy0) // 2,
                    ox // 2 : (ox + sx1 - sx0) // 2,
                ] = ptile_c[sy0 // 2 : sy1 // 2, sx0 // 2 : sx1 // 2]
        return out_y, out_c

    def _region_tile_ids(
        self, page: TiffPage, level: int, locations: "np.ndarray",
        size: tuple[int, int],
    ) -> list[int]:
        """Sorted unique TIFF tile ids covered by the given level-0 regions
        (exact per-region coverage — see prefetch_regions), capped at the
        cache capacity."""
        ds = self.level_downsamples[level]
        w, h = size
        id_set: set[int] = set()
        for lx0, ly0 in np.asarray(locations).reshape(-1, 2):
            x0 = int(round(int(lx0) / ds))
            y0 = int(round(int(ly0) / ds))
            tx0, tx1, ty0, ty1 = _tile_cover(page, x0, y0, w, h)
            for ty in range(ty0, ty1 + 1):
                for tx in range(tx0, tx1 + 1):
                    id_set.add(ty * page.tiles_across + tx)
        # ids past a truncated offsets tag are undecodable — drop them here
        # so both prefetch paths stay crash-free
        n_tiles = len(page.offsets)
        return sorted(i for i in id_set if i < n_tiles)[: self._cache_cap]

    @staticmethod
    def _entry_nbytes(v: Any) -> int:
        if v is None:
            return 0
        if isinstance(v, tuple):
            return sum(int(a.nbytes) for a in v)
        return int(v.nbytes)

    def _cache_put_locked(self, key: tuple[str, int, int], value: Any) -> None:
        """Insert + evict under BOTH budgets (entries and bytes). Caller
        holds ``self._cache_lock``. An entry larger than the whole byte
        budget (a huge strip) is immediately evicted again — it simply
        never caches, which is the correct degradation."""
        if key in self._cache:
            self._cache_bytes -= self._entry_nbytes(self._cache.pop(key))
        self._cache[key] = value
        self._cache_bytes += self._entry_nbytes(value)
        while self._cache and (
            len(self._cache) > self._cache_cap
            or self._cache_bytes > self._cache_bytes_cap
        ):
            _, v = self._cache.popitem(last=False)
            self._cache_bytes -= self._entry_nbytes(v)

    def _decode_tile_planar_cached(
        self, level: int, page: TiffPage, idx: int
    ) -> tuple[np.ndarray, np.ndarray] | None:
        key = ("p", level, idx)
        with self._cache_lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                return self._cache[key]  # may be the None failure sentinel
        out = self._native.decode_jpeg_batch_planar(
            [self._tile_bytes(page, idx)],
            page.tile_height, page.tile_width, page.jpeg_tables,
        )
        planes = None if out is None else (out[0][0], out[1][0])
        if self._cache_cap > 0:
            with self._cache_lock:
                # cache failures too (None sentinel) — a non-4:2:0/odd tile
                # would otherwise be re-decoded on every chunk touching it
                self._cache_put_locked(key, planes)
        return planes

    def _decode_tile_cached(
        self, level: int, page: TiffPage, idx: int
    ) -> np.ndarray | None:
        key = ("rgb", level, idx)
        with self._cache_lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                return self._cache[key]
        tile = self._decode_tile(page, idx)
        if tile is not None and self._cache_cap > 0:
            with self._cache_lock:
                self._cache_put_locked(key, tile)
        return tile

    def _tile_bytes(self, page: TiffPage, idx: int) -> bytes:
        off, cnt = int(page.offsets[idx]), int(page.byte_counts[idx])
        # clamp to the file: os.pread pre-allocates `cnt` bytes, so a
        # corrupt 32-bit byte count (~4 GB) would trigger a multi-GB
        # allocation before the read even fails — fail closed instead
        if off <= 0 or cnt <= 0 or off >= self._fsize:
            return b""
        cnt = min(cnt, self._fsize - off)
        # positional read: stateless, so concurrent prefetch threads can
        # decode batches without racing a shared seek cursor
        import os

        return os.pread(self._f.fileno(), cnt, off)

    def _decode_tile(self, page: TiffPage, idx: int) -> np.ndarray | None:
        if idx < 0 or idx >= len(page.offsets):
            return None
        if page.byte_counts[idx] == 0 or page.offsets[idx] == 0:
            return None  # sparse-tile convention: blank (background) tile
        data = self._tile_bytes(page, idx)
        tw, th = page.tile_width, page.tile_height
        if page.is_strips:
            # the LAST strip carries only the remaining rows — decode the
            # actual height so raw codecs don't mis-reshape it
            th = min(th, page.height - idx * page.tile_height)
        err = _page_decode_unsupported(page)
        if err:
            # decoding anyway would silently emit scrambled pixels
            # (separate planes misread as spatial chunks, palette indices
            # reshaped as RGB, 16-bit reinterpreted as uint8)
            raise ValueError(f"unsupported page layout: {err}")
        comp = page.compression
        if comp == 7:  # new-style JPEG
            (out,), status = self._native.decode_jpeg_status(
                [data], th, tw, page.jpeg_tables
            )
            if status[0] == 0:
                return out[0]
            with self._cache_lock:
                self.decoder_refusals += 1
                self.decoder_refusal_reasons[REFUSALS[int(status[0])]] += 1
            return _decode_jpeg_pil(data, page.jpeg_tables)
        if comp in (8, 32946):  # deflate
            raw = zlib.decompress(data)
            return _raw_to_rgb(raw, th, tw, page.samples, page.predictor,
                                page.bits_per_sample)
        if comp == 5:
            return _raw_to_rgb(_lzw_decode(data), th, tw, page.samples,
                                page.predictor, page.bits_per_sample)
        if comp == 32773:
            return _raw_to_rgb(_packbits_decode(data), th, tw, page.samples,
                                page.predictor, page.bits_per_sample)
        if comp == 1:
            return _raw_to_rgb(data, th, tw, page.samples, page.predictor,
                                page.bits_per_sample)
        if comp in (33003, 33005, 34712):  # JPEG2000 (Aperio / generic)
            img = _pil_rgb(data)
            if img is None:
                raise ValueError(f"JPEG2000 tile decode failed (compression {comp})")
            return img
        raise ValueError(f"unsupported TIFF compression {comp}")

    def close(self) -> None:
        self._f.close()


def _tile_cover(
    page: TiffPage, x0: int, y0: int, w: int, h: int
) -> tuple[int, int, int, int]:
    """Inclusive (tx0, tx1, ty0, ty1) tile-grid range covering the level-px
    region — ONE definition so read_region / read_region_planar / prefetch
    can never disagree about which tiles a region touches."""
    tw, th = page.tile_width, page.tile_height
    tx0 = max(x0 // tw, 0)
    tx1 = min((x0 + w - 1) // tw, page.tiles_across - 1)
    ty0 = max(y0 // th, 0)
    ty1 = min((y0 + h - 1) // th, page.tiles_down - 1)
    return tx0, tx1, ty0, ty1


_SUPPORTED_COMPRESSIONS = {1, 5, 7, 8, 32946, 32773, 33003, 33005, 34712}


def _page_decode_unsupported(page: TiffPage) -> str | None:
    """Reason this page cannot be decoded correctly, or None. ONE
    definition shared by the constructor preflight (strip-backed pyramids
    must fail early so open_slide's PIL fallback can rescue the file) and
    _decode_tile (fail closed instead of emitting scrambled pixels)."""
    if page.compression not in _SUPPORTED_COMPRESSIONS:
        return f"compression {page.compression}"
    if page.planar_config == 2 and page.samples > 1:
        # applies to JPEG too: each plane blob would decode as an
        # independent grayscale image and read back monochrome/garbled
        return "PlanarConfiguration=2 (separate sample planes)"
    if page.compression in (1, 5, 8, 32946, 32773):
        if page.bits_per_sample != 8:
            return f"BitsPerSample {page.bits_per_sample} (only 8)"
        if page.photometric not in (1, 2):
            return (f"photometric {page.photometric} with raw codec "
                    f"(only grayscale/RGB)")
    return None


def _is_pyramid_level(page: TiffPage, base_w: int, base_h: int) -> bool:
    """Heuristic: pyramid levels downsample the base by a near-integer
    factor on BOTH axes with matching factors. Label/macro pages fail the
    near-integer test (absolute tolerance accounts only for the ±factor
    rounding of ceil(base/ds) dims) or the aspect check."""
    rw = base_w / page.width
    rh = base_h / page.height
    near_w, near_h = round(rw), round(rh)
    if near_w < 1 or near_h < 1 or near_w != near_h:
        return False
    tol_w = max(0.02, 2.0 * near_w / page.width)
    tol_h = max(0.02, 2.0 * near_h / page.height)
    return abs(rw - near_w) <= tol_w and abs(rh - near_h) <= tol_h


def _parse_mpp(page: TiffPage) -> float | None:
    desc = page.description or ""
    # Aperio: "...|MPP = 0.2520|..."
    for part in desc.replace("\n", "|").split("|"):
        if "MPP" in part and "=" in part:
            try:
                return float(part.split("=")[1].strip())
            except ValueError:
                pass
    if page.x_resolution:
        if page.resolution_unit == 3:  # pixels per cm
            return 10000.0 / page.x_resolution
        if page.resolution_unit == 2:  # pixels per inch (the TIFF default)
            return 25400.0 / page.x_resolution
    return None


def _pil_rgb(data: bytes) -> np.ndarray | None:
    """Decode a whole image through PIL to RGB uint8, or None."""
    import io

    from PIL import Image

    try:
        with Image.open(io.BytesIO(data)) as img:
            return np.asarray(img.convert("RGB"))
    except (OSError, SyntaxError, ValueError):  # PIL's ways to say "not decodable"
        return None


def _decode_jpeg_pil(data: bytes, tables: bytes | None) -> np.ndarray:
    """A JPEG tile the port's decoder refused, through PIL: the JAX
    package's cv2 route (``_decode_jpeg``) with PIL in cv2's place."""
    if tables and len(tables) > 4 and not data.startswith(b"\xff\xd8\xff\xdb"):
        # merge shared quant/huffman tables: tables = FFD8 ... FFD9,
        # tile = FFD8 <scan>; splice: FFD8 + tables-body + tile-body
        img = _pil_rgb(data[:2] + tables[2:-2] + data[2:])
        if img is None:
            img = _pil_rgb(data)
    else:
        img = _pil_rgb(data)
    if img is None:
        raise ValueError("JPEG tile decode failed")
    return img


def _raw_to_rgb(
    raw: bytes, height: int, width: int, samples: int, predictor: int = 1,
    bits: int = 8,
) -> np.ndarray:
    if bits != 8:
        # reinterpreting 16-bit (etc.) data as uint8 would silently emit a
        # scrambled tile — fail closed instead
        raise ValueError(f"unsupported BitsPerSample {bits} (only 8)")
    arr = np.frombuffer(raw, np.uint8)
    expect = height * width * samples
    row = width * samples
    if arr.size < expect:
        # some writers emit undersized EDGE tiles with whole rows missing —
        # white-pad only that row-aligned case; anything else is truncation
        if arr.size % row:
            raise ValueError(
                f"raw tile has {arr.size} bytes, expected {expect} "
                f"(not row-aligned; truncated or mis-declared layout)"
            )
        arr = np.pad(arr, (0, expect - arr.size), constant_values=255)
    arr = arr[:expect].reshape(height, width, samples)
    if predictor == 2:
        # TIFF horizontal differencing (tag 317): undo via per-row cumulative
        # sum along x, per sample channel, modulo 256
        arr = np.cumsum(arr.astype(np.uint64), axis=1).astype(np.uint8)
    if samples >= 3:
        return np.ascontiguousarray(arr[:, :, :3])
    return np.repeat(arr[:, :, :1], 3, axis=2)
