"""Slide-list generation, in the port — the reference's
``generate_slide_list.py`` (SURVEY.md §2 C23) as the JAX package's
``cli/generate_slide_list.py`` has it: scan DATA_PATH recursively for WSIs,
write one path per line, print a per-extension summary and array-job next
steps. Exit 1 when no slide is found. Needs no card.
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter
from pathlib import Path

from path_gene_multimodal_tpu_torch.config import default_config, slide_paths
from path_gene_multimodal_tpu_torch.utils.log import get_logger


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--output", default="wsi_list.txt")
    args = ap.parse_args(argv)
    logger = get_logger()
    cfg = default_config()
    data_path = Path(args.data_path or cfg.data_path)
    wsis = slide_paths(data_path)
    if not wsis:
        logger.error("no WSIs found under %s", data_path)
        return 1
    out = Path(args.output)
    out.write_text("\n".join(str(p) for p in wsis) + "\n")
    by_ext = Counter(p.suffix.lower() for p in wsis)
    logger.info("wrote %d slides to %s", len(wsis), out)
    for ext, n in sorted(by_ext.items()):
        logger.info("  %s: %d", ext, n)
    logger.info(
        "next: submit an array job of size %d where task i runs\n"
        '  WSI_PATH=$(sed -n "${i}p" %s) python -m path_gene_multimodal_tpu_torch.cli.main',
        len(wsis), out,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
