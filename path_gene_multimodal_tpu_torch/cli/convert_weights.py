"""Convert published torch checkpoints to torch-free artifacts, in the port.

The JAX package's ``cli/convert_weights.py`` with its arguments, kinds and
output: each external checkpoint the reference consumes becomes one
``.npz`` (the JAX package's flax-layout params + the architecture config),
which either package's ``core.checkpoints.load_converted`` reads:

- ``hovernext``: ``pannuke_convnextv2_tiny_3`` (reference consumer
  ``hovernet_inference.py:82-131``), the published smp/timm multi-head
  layout or the canonical naming, told apart by their keys;
- ``clip`` / ``virchow2``: the tile-embedding towers
  (``extract_embedding_from_tiles.py:14``, MODEL_TYPE CLIP|Virchow2);
  CLIP text weights, when present, are written to ``<out>_text.npz``;
- ``resnet34``: the six ``resnet34-idars-*`` molecular predictors
  (``molecular_feature_extraction.py:21-28``), one run per task file;
- ``convnext``: a bare FCMAE/timm ConvNeXtV2 encoder.

The port's own CLIs read these artifacts (``cli.main --weights``,
``cli.hovernext_infer --checkpoint``, ``cli.molecular_loop
--weights-dir``). Conversion needs no card.

Usage::

    python -m path_gene_multimodal_tpu_torch.cli.convert_weights \\
        hovernext pannuke_convnextv2_tiny_3/best_model out/hovernext.npz

Conversion is strict by default: any checkpoint key the mapping does not
consume raises (a naming mismatch should be loud, not a silently
half-loaded model). ``--lenient`` downgrades that to a warning.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from path_gene_multimodal_tpu_torch.utils.log import get_logger

KINDS = ("clip", "virchow2", "hovernext", "resnet34", "convnext")


def convert(kind: str, src: str | Path, out: str | Path,
            allow_pickle: bool = False, lenient: bool = False) -> list[Path]:
    """Programmatic entry — returns the written artifact paths."""
    from path_gene_multimodal_tpu_torch.core import checkpoints as ck
    from path_gene_multimodal_tpu_torch.models.weights import load_torch_checkpoint

    logger = get_logger()
    written: list[Path] = []
    strict = not lenient
    if kind == "clip":
        vcfg, vparams, tcfg, tparams = ck.load_clip_from_torch(src, allow_pickle=allow_pickle)
        written.append(ck.save_converted("clip", vcfg, vparams, out))
        if tparams is not None:
            written.append(ck.save_converted("clip_text", tcfg, tparams,
                                             ck.text_sidecar_path(out)))
    elif kind in ("virchow2", "hovernext"):
        sd = load_torch_checkpoint(src, allow_pickle=allow_pickle)
        if kind == "virchow2":
            from path_gene_multimodal_tpu_torch.models.weights_vit_timm import convert_timm_vit

            cfg, variables, leftover = convert_timm_vit(sd)
            what, hint = "timm ViT", "pass strict=False to get them back for manual wiring"
        else:
            if ck._is_real_hovernext_layout(sd):
                from path_gene_multimodal_tpu_torch.models.weights_hovernext_real import (
                    convert_real_hovernext as convert_layout,
                )
            else:
                from path_gene_multimodal_tpu_torch.models.weights_hovernext import (
                    convert_hovernext as convert_layout,
                )
            cfg, variables, leftover = convert_layout(sd)
            what, hint = ("HoverNeXt", "re-key the checkpoint to the documented layout or "
                                       "pass strict=False")
        if leftover and strict:  # the JAX package's loaders' message
            raise ValueError(f"{len(leftover)} checkpoint keys were not consumed by the {what} "
                             f"mapping (first 10: {sorted(leftover)[:10]}); {hint}")
        if leftover:
            logger.warning("%d unconsumed checkpoint keys (lenient)", len(leftover))
        written.append(ck.save_converted(kind, cfg, variables, out))
    elif kind == "resnet34":
        from path_gene_multimodal_tpu_torch.models.weights_resnet import convert_resnet34

        variables = convert_resnet34(load_torch_checkpoint(src, allow_pickle=allow_pickle))
        written.append(ck.save_converted("resnet34", None, variables, out))
    elif kind == "convnext":
        cfg, variables, leftover = ck.load_convnext_encoder_from_torch(
            src, allow_pickle=allow_pickle)
        if leftover:
            msg = f"{len(leftover)} non-encoder keys not converted (decoder/head)"
            if strict:
                raise ValueError(msg + "; use kind=hovernext for full checkpoints "
                                       "or pass --lenient")
            logger.warning("%s (lenient)", msg)
        written.append(ck.save_converted("convnext", cfg, variables, out))
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return written


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kind", choices=KINDS)
    ap.add_argument("src", help="torch checkpoint (.pt/.pth/.bin)")
    ap.add_argument("out", help="output artifact path (.npz)")
    ap.add_argument(
        "--allow-pickle", action="store_true",
        help="permit full unpickling for trusted checkpoints that "
             "weights_only=True cannot read",
    )
    ap.add_argument(
        "--lenient", action="store_true",
        help="warn instead of raising on unconsumed checkpoint keys",
    )
    args = ap.parse_args(argv)
    logger = get_logger()

    from path_gene_multimodal_tpu_torch.core.checkpoints import flatten_params, load_converted

    written = convert(args.kind, args.src, args.out,
                      allow_pickle=args.allow_pickle, lenient=args.lenient)
    for p in written:
        kind, cfg, variables = load_converted(p)  # read-back self-check
        logger.info("wrote %s: kind=%s, %.1fM params, config=%s",
                    p, kind, sum(np.size(v) for v in flatten_params(variables).values()) / 1e6,
                    cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
