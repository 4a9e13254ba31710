"""ASAP/TIGER XML annotation parsing + overlay, in the port.

The JAX package's ``io/asap.py`` (the reference's
``publicly_annotated_file_tme_match.py``, SURVEY.md §2 C21): parse
ASAP-format annotation XML (TIGER dataset) into Order-sorted polygon
coordinate arrays (``:15-47``), and draw them over slide thumbnails
(``:49-125``). The port never loads matplotlib: each polygon is a closed
1-px ring on the thumbnail, in matplotlib's tab10 colours (as RGB numbers)
by sorted group, or in #d62728 when not coloured by group, with no legend
or axes, written through ``io/png.py`` under the JAX package's file names.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Any

import numpy as np

from path_gene_multimodal_tpu_torch.io.png import write_png
from path_gene_multimodal_tpu_torch.io.slide import SlideReader

# matplotlib's tab10, in its order
TAB10 = (
    (31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40), (148, 103, 189),
    (140, 86, 75), (227, 119, 194), (127, 127, 127), (188, 189, 34), (23, 190, 207),
)
SINGLE_COLOR = (214, 39, 40)  # #d62728


def parse_asap_xml(xml_path: str | Path) -> list[dict[str, Any]]:
    """→ [{name, group, coords (K, 2) level-0 float, type}] with per-polygon
    coordinates sorted by their ``Order`` attribute (ref :15-47)."""
    root = ET.parse(str(xml_path)).getroot()
    out: list[dict[str, Any]] = []
    for ann in root.iter("Annotation"):
        coords_el = ann.find("Coordinates")
        if coords_el is None:
            continue
        pts = []
        for c in coords_el.iter("Coordinate"):
            try:
                order = int(float(c.get("Order", "0")))
                x = float(c.get("X"))
                y = float(c.get("Y"))
            except (TypeError, ValueError):
                continue
            pts.append((order, x, y))
        if len(pts) < 3:
            continue
        pts.sort(key=lambda t: t[0])
        out.append(
            {
                "name": ann.get("Name", ""),
                "group": ann.get("PartOfGroup", ""),
                "type": ann.get("Type", "Polygon"),
                "coords": np.asarray([(x, y) for _, x, y in pts], np.float64),
            }
        )
    return out


def overlay_asap_annotations(
    slide: SlideReader,
    xml_path: str | Path,
    out_path: str | Path,
    thumb_size: tuple[int, int] = (2000, 2000),
    color_by_group: bool = True,
) -> Path:
    """Annotation polygons over the slide thumbnail (ref :49-125) → a PNG."""
    from path_gene_multimodal_tpu_torch.pipeline.morphology import draw_polyline

    anns = parse_asap_xml(xml_path)
    img = np.array(slide.get_thumbnail(thumb_size), dtype=np.uint8)
    w0, _ = slide.level_dimensions[0]
    scale = img.shape[1] / w0
    groups = sorted({a["group"] for a in anns})
    color_of = {g: TAB10[i % 10] for i, g in enumerate(groups)}
    for a in anns:
        ring = a["coords"] * scale
        draw_polyline(img, np.concatenate([ring, ring[:1]]),
                      color_of[a["group"]] if color_by_group else SINGLE_COLOR)
    return write_png(out_path, img)


def overlay_for_slide_dir(
    slides_dir: str | Path,
    xml_dir: str | Path,
    out_dir: str | Path,
    **kw: Any,
) -> dict[str, Path]:
    """Pair each slide with its same-stem XML and save overlays
    (ref script body :159-203)."""
    from path_gene_multimodal_tpu_torch.config import slide_paths
    from path_gene_multimodal_tpu_torch.io.slide import open_slide

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    outputs: dict[str, Path] = {}
    for wsi in slide_paths(slides_dir):
        xml = Path(xml_dir) / f"{wsi.stem}.xml"
        if not xml.exists():
            continue
        slide = open_slide(wsi)
        try:
            outputs[wsi.stem] = overlay_asap_annotations(
                slide, xml, out_dir / f"{wsi.stem}_annotation_overlay.png", **kw
            )
        finally:
            # one leaked fd per slide would EMFILE a long TIGER directory
            getattr(slide, "close", lambda: None)()
    return outputs
