"""Minimal TIFF pyramid writer (classic little-endian TIFF or BigTIFF).

A copy of the JAX package's ``io/tiff_write.py``: it materializes synthetic
slides as real ``.svs``-style files, so that the port's ``TiffTileSlide``
and tile decoder are driven end to end (by the tests and ``chip_smoke.py``).

Two page layouts through one IFD emitter:

- tiled (tags 322-325) — the Aperio/SVS layout (``write_tiled_tiff``);
- striped (tags 273/278/279) — libvips/CAMELYON-style exports and plain
  ``tifffile`` saves (``write_striped_tiff``); the last strip carries only
  the remaining rows, matching real writers.

``write_tiff_pages`` mixes both in one file (an SVS holds a tiled pyramid
plus striped thumbnail/label/macro pages).

Compression: 8 (deflate via zlib), 7 (JPEG), 1 (raw) and — tiled only —
33003/33005 (Aperio JPEG2000: lossless raw J2K codestreams, the tile
payload convention of TCGA SVS slides, where each tile is a bare
``FF4F FF51`` codestream rather than a JP2 container).

The JAX package encodes through OpenCV; the port encodes through PIL,
imported where it is used. PIL's JPEG at ``quality=q, subsampling=2``
(4:2:0) writes the same bytes as OpenCV's ``imencode`` at quality q (both
libjpeg-turbo with its default tables and settings;
``tests/test_torch_tiff.py`` holds the files equal). Its J2K is lossless
too, so the pixels are equal, but the codestream bytes may differ from
OpenCV's.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Any

import numpy as np

_T_SHORT, _T_LONG, _T_RATIONAL, _T_ASCII = 3, 4, 5, 2


def _entry(tag: int, typ: int, count: int, value: int) -> bytes:
    return struct.pack("<HHII", tag, typ, count, value)


def encode_jpeg(rgb: np.ndarray, quality: int = 90) -> bytes:
    """Baseline JPEG of an RGB uint8 image: YCbCr 4:2:0, libjpeg's default
    tables (PIL; the bytes OpenCV's ``imencode`` writes)."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(rgb)).save(
        buf, format="JPEG", quality=quality, subsampling=2)
    return buf.getvalue()


def _encode_chunk(chunk: np.ndarray, compression: int, jpeg_quality: int) -> bytes:
    """Compress one tile/strip of RGB uint8 pixels."""
    if compression == 8:
        return zlib.compress(chunk.tobytes(), 6)
    if compression == 7:
        return encode_jpeg(chunk, jpeg_quality)
    if compression in (33003, 33005):
        import io

        from PIL import Image

        buf = io.BytesIO()
        # lossless (reversible 5/3 wavelet); Aperio stores bare J2K
        # codestreams, not JP2 containers
        Image.fromarray(np.ascontiguousarray(chunk)).save(
            buf, format="JPEG2000", no_jp2=True, irreversible=False)
        b = buf.getvalue()
        if not b.startswith(b"\xff\x4f\xff\x51"):
            raise ValueError("no J2K codestream in the JPEG2000 output")
        return b
    if compression == 1:
        return chunk.tobytes()
    # writing raw bytes while tag 259 advertises another codec would
    # produce a corrupt TIFF — fail loudly
    raise ValueError(
        f"unsupported write compression {compression} "
        "(supported: 1 raw, 7 JPEG, 8 deflate, 33003/33005 J2K tiled)"
    )


def write_tiff_pages(
    path: str | Path, pages: list[dict[str, Any]], bigtiff: bool = False
) -> Path:
    """Write a multi-page TIFF from page specs. Each spec:

    ``{"img": HxWx3 uint8, "layout": "tiled"|"striped",
       "tile_size": int (tiled), "rows_per_strip": int (striped),
       "compression": int, "jpeg_quality": int, "description": str}``

    Only ``img`` is required; defaults: tiled, tile_size 256,
    rows_per_strip 64, deflate, quality 90, no description.

    ``bigtiff=True`` emits the BigTIFF container (magic 43, 64-bit
    offsets, 20-byte IFD entries) — the layout of Ventana/Philips WSIs —
    so the reader's BigTIFF branch has a real fixture.
    """
    path = Path(path)
    if bigtiff:
        # II, magic 43, offset-size 8, pad 0, IFD0 pointer (Q, patched)
        blob = bytearray(b"II+\x00\x08\x00\x00\x00" + b"\x00" * 8)
        ifd0_ptr, ptr_fmt = 8, "<Q"
        ent = lambda tag, typ, count, value: struct.pack(  # noqa: E731
            "<HHQQ", tag, typ, count, value
        )
    else:
        blob = bytearray(b"II*\x00\x00\x00\x00\x00")
        ifd0_ptr, ptr_fmt = 4, "<I"
        ent = _entry

    inline_size = 8 if bigtiff else 4

    def arr_ent(tag: int, typ: int, count: int, raw: bytes, arr_pos: int) -> bytes:
        """Array-valued entry: TIFF stores values ≤ the inline field size
        IN the value field, larger arrays behind a pointer — and the
        inline capacity differs (4 classic vs 8 BigTIFF), so e.g. a
        3×SHORT BitsPerSample is out-of-line classic but inline BigTIFF."""
        if len(raw) <= inline_size:
            return ent(tag, typ, count,
                       int.from_bytes(raw.ljust(inline_size, b"\x00"), "little"))
        return ent(tag, typ, count, arr_pos)

    def _align() -> None:
        while len(blob) % 2:
            blob.append(0)

    emitted = []  # (spec, w, h, offsets, counts)
    for spec in pages:
        img = np.ascontiguousarray(spec["img"], dtype=np.uint8)
        h, w = img.shape[:2]
        layout = spec.get("layout", "tiled")
        compression = spec.get("compression", 8)
        quality = spec.get("jpeg_quality", 90)
        offsets, counts = [], []
        if layout == "tiled":
            ts = spec.get("tile_size", 256)
            for ty in range((h + ts - 1) // ts):
                for tx in range((w + ts - 1) // ts):
                    tile = np.full((ts, ts, 3), 255, np.uint8)
                    sub = img[ty * ts : (ty + 1) * ts, tx * ts : (tx + 1) * ts]
                    tile[: sub.shape[0], : sub.shape[1]] = sub
                    data = _encode_chunk(tile, compression, quality)
                    _align()
                    offsets.append(len(blob))
                    counts.append(len(data))
                    blob.extend(data)
        elif layout == "striped":
            if compression not in (1, 7, 8):
                raise ValueError(
                    f"unsupported write compression {compression} for "
                    "striped pages (supported: 1 raw, 7 JPEG, 8 deflate)"
                )
            rps = spec.get("rows_per_strip", 64)
            for ys in range(0, h, rps):
                data = _encode_chunk(img[ys : ys + rps], compression, quality)
                _align()
                offsets.append(len(blob))
                counts.append(len(data))
                blob.extend(data)
        else:
            raise ValueError(f"unknown page layout {layout!r}")
        emitted.append((spec, w, h, offsets, counts))

    prev_next_ptr = ifd0_ptr  # header's IFD0 pointer
    for spec, w, h, offsets, counts in emitted:
        layout = spec.get("layout", "tiled")
        compression = spec.get("compression", 8)
        description = spec.get("description", "")
        desc_bytes = description.encode("latin-1") + b"\x00"
        # out-of-line arrays (dead bytes when the entry inlines instead)
        _align()
        off_raw = struct.pack(f"<{len(offsets)}I", *offsets)
        off_arr_pos = len(blob)
        blob.extend(off_raw)
        cnt_raw = struct.pack(f"<{len(counts)}I", *counts)
        cnt_arr_pos = len(blob)
        blob.extend(cnt_raw)
        bps_raw = struct.pack("<3H", 8, 8, 8)
        bps_pos = len(blob)
        blob.extend(bps_raw)
        desc_pos = len(blob)
        if description:
            blob.extend(desc_bytes)
        _align()
        ifd_pos = len(blob)
        entries = [
            ent(256, _T_LONG, 1, w),
            ent(257, _T_LONG, 1, h),
            arr_ent(258, _T_SHORT, 3, bps_raw, bps_pos),
            ent(259, _T_SHORT, 1, compression),
            ent(262, _T_SHORT, 1, 6 if compression == 7 else 2),  # YCbCr for JPEG
            ent(277, _T_SHORT, 1, 3),
        ]
        if layout == "tiled":
            ts = spec.get("tile_size", 256)
            entries += [
                ent(322, _T_LONG, 1, ts),
                ent(323, _T_LONG, 1, ts),
                arr_ent(324, _T_LONG, len(offsets), off_raw, off_arr_pos),
                arr_ent(325, _T_LONG, len(counts), cnt_raw, cnt_arr_pos),
            ]
        else:
            entries += [
                arr_ent(273, _T_LONG, len(offsets), off_raw, off_arr_pos),
                ent(278, _T_LONG, 1, spec.get("rows_per_strip", 64)),
                arr_ent(279, _T_LONG, len(counts), cnt_raw, cnt_arr_pos),
            ]
        if description:
            entries.append(arr_ent(270, _T_ASCII, len(desc_bytes), desc_bytes, desc_pos))
        entries.sort(key=lambda e: struct.unpack("<H", e[:2])[0])
        # patch previous IFD's next pointer → this IFD
        struct.pack_into(ptr_fmt, blob, prev_next_ptr, ifd_pos)
        blob.extend(struct.pack("<Q" if bigtiff else "<H", len(entries)))
        for e in entries:
            blob.extend(e)
        next_ptr_pos = len(blob)
        blob.extend(struct.pack(ptr_fmt, 0))
        prev_next_ptr = next_ptr_pos

    path.write_bytes(bytes(blob))
    return path


def write_tiled_tiff(
    path: str | Path,
    levels: list[np.ndarray],
    tile_size: int = 256,
    compression: int = 8,
    jpeg_quality: int = 90,
    description: str = "",
) -> Path:
    """Write an RGB pyramid as a multi-page tiled TIFF."""
    return write_tiff_pages(
        path,
        [
            {
                "img": img,
                "layout": "tiled",
                "tile_size": tile_size,
                "compression": compression,
                "jpeg_quality": jpeg_quality,
                "description": description if i == 0 else "",
            }
            for i, img in enumerate(levels)
        ],
    )


def write_striped_tiff(
    path: str | Path,
    levels: list[np.ndarray],
    rows_per_strip: int = 64,
    compression: int = 8,
    jpeg_quality: int = 90,
    description: str = "",
) -> Path:
    """Write an RGB pyramid as a multi-page STRIPED TIFF — the layout of
    non-Aperio exports (libvips/CAMELYON-style pyramids, plain ``tifffile``
    saves)."""
    return write_tiff_pages(
        path,
        [
            {
                "img": img,
                "layout": "striped",
                "rows_per_strip": rows_per_strip,
                "compression": compression,
                "jpeg_quality": jpeg_quality,
                "description": description if i == 0 else "",
            }
            for i, img in enumerate(levels)
        ],
    )
