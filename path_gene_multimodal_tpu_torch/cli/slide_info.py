"""Slide inspector, in the port — print a WSI's pyramid structure, codec
and scan metadata without running any pipeline stage.

The JAX package's ``cli/slide_info.py`` over the port's own reader stack
(``io/tiff.py`` + ``io/slide.py``), with the same dict, the same human
output and the same ``--json`` lines; ``native_decoder`` reports the port's
decoder (``io/native.py``), which every TIFF slide of the port holds.
Host-only, needs no card:

    python -m path_gene_multimodal_tpu_torch.cli.slide_info case.svs [more.svs ...] [--json]

Exit 2 when a slide cannot be read (the others are still printed).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

# TIFF tag 259 values seen in the WSI wild
_CODEC_NAMES = {
    1: "uncompressed",
    5: "LZW",
    7: "JPEG",
    8: "deflate",
    32946: "deflate (legacy id)",
    32773: "PackBits",
    33003: "JPEG2000 (Aperio YCbCr)",
    33005: "JPEG2000 (Aperio RGB)",
    34712: "JPEG2000",
}

_PHOTOMETRIC = {0: "white-is-zero", 1: "black-is-zero", 2: "RGB", 6: "YCbCr"}


def slide_info(path: str | Path) -> dict:
    """Metadata dict for one slide (shape shared by --json and the
    pretty-printer). Raises on unreadable files."""
    from path_gene_multimodal_tpu_torch.io.slide import open_slide
    from path_gene_multimodal_tpu_torch.io.tiff import TiffTileSlide

    path = Path(path)
    slide = open_slide(path)
    info: dict = {
        "path": str(path),
        "reader": type(slide).__name__,
        "file_bytes": path.stat().st_size if path.exists() else None,
        "level_dimensions": [list(d) for d in slide.level_dimensions],
        "level_downsamples": [round(d, 4) for d in slide.level_downsamples],
        "mpp": getattr(slide, "mpp", None),
    }
    if isinstance(slide, TiffTileSlide):
        info["pages"] = [{
            "level": lv,
            "size": [p.width, p.height],
            "tile": [p.tile_width, p.tile_height],
            "tiles": [p.tiles_across, p.tiles_down],
            "strips": p.is_strips,
            "codec": _CODEC_NAMES.get(p.compression, f"unknown({p.compression})"),
            "photometric": _PHOTOMETRIC.get(p.photometric, str(p.photometric)),
            "bits_per_sample": p.bits_per_sample,
            "jpeg_tables": p.jpeg_tables is not None,
        } for lv, p in enumerate(slide._pages)]
        info["associated_images"] = {
            n: [p.width, p.height] for n, p in slide._associated_pages.items()
        }
        info["description"] = (slide._pages[0].description or "").splitlines()[:2]
        info["native_decoder"] = slide._native is not None
        info["planar_feed_supported"] = bool(slide.supports_planar(0))
    getattr(slide, "close", lambda: None)()
    return info


def _print_human(info: dict) -> None:
    w, h = info["level_dimensions"][0]
    print(f"{info['path']}")
    print(f"  reader: {info['reader']}   size: {w}x{h}   mpp: {info['mpp']}")
    print(f"  levels: {len(info['level_dimensions'])}  "
          f"downsamples: {info['level_downsamples']}")
    for pg in info.get("pages", []):
        print(
            f"  level {pg['level']}: {pg['size'][0]}x{pg['size'][1]} "
            + (f"strips of {pg['tile'][1]} rows ({pg['tiles'][1]} strips) "
               if pg.get("strips") else
               f"tile {pg['tile'][0]}x{pg['tile'][1]} ({pg['tiles'][0]}x{pg['tiles'][1]} tiles) ")
            + f"{pg['codec']} {pg['photometric']} {pg['bits_per_sample']}-bit"
            + (" +JPEGTables" if pg["jpeg_tables"] else "")
        )
    if info.get("associated_images"):
        assoc = ", ".join(f"{n} {w}x{h}" for n, (w, h) in info["associated_images"].items())
        print(f"  associated: {assoc}")
    if "native_decoder" in info:
        print(f"  native decoder: {info['native_decoder']}   "
              f"planar feed: {info['planar_feed_supported']}")
    for line in info.get("description", []):
        print(f"  description: {line}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+", help="slide files to inspect")
    ap.add_argument("--json", action="store_true", help="one JSON object per slide on stdout")
    args = ap.parse_args(argv)

    rc = 0
    for p in args.paths:
        try:
            info = slide_info(p)
        except Exception as e:
            print(f"{p}: UNREADABLE ({type(e).__name__}: {e})", file=sys.stderr)
            rc = 2
            continue
        if args.json:
            print(json.dumps(info))
        else:
            _print_human(info)
    return rc


if __name__ == "__main__":
    sys.exit(main())
