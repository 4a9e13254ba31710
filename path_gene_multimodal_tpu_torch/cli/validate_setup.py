"""Pre-run environment validation, in the port — the reference's
``validate_setup.py`` (SURVEY.md §2 C22) as the JAX package's
``cli/validate_setup.py`` has it, for the card:

1. path checks + WSI count (``:20-62``);
2. config invariants: TME_CLASSES ⊆ classes, positive sizes (``:65-109``);
3. import smoke test of the port's pipeline modules (``:112-137``);
4. runtime components: the port's tile decoder (``io/native.py``, built
   with g++ at first use), the CLIP vocab, and the CUDA kernels
   (``ops/cuda.py``, built with nvcc at first use, then loaded);
5. accelerator check: ``torch.cuda.is_available()`` and the device names
   (``:140-165``'s CUDA check).

A missing component warns, as in the JAX package; with
``--require-accelerator`` a run without a CUDA device fails, and so does a
kernel build or load that fails on a CUDA machine (nothing falls back).
Exit code 0 when everything passes, 1 otherwise (``:210-221``).
"""

from __future__ import annotations

import argparse
import importlib
import sys
from pathlib import Path

from path_gene_multimodal_tpu_torch.config import default_config, slide_paths
from path_gene_multimodal_tpu_torch.utils.log import get_logger

PIPELINE_MODULES = tuple(
    f"path_gene_multimodal_tpu_torch.pipeline.{m}" for m in (
        "tessellate", "embed", "spatial", "polygons", "overlay", "nuclei", "nuclei_wsi",
        "molecular", "graph", "graph_stats", "morphology", "altpaths", "legacy", "plotting",
        "runner")
)


def check_paths(cfg, logger) -> bool:
    ok = True
    if not cfg.data_path:
        logger.warning("DATA_PATH not configured")
    else:
        p = Path(cfg.data_path)
        if not p.exists():
            logger.error("DATA_PATH does not exist: %s", p)
            ok = False
        else:
            n = len(slide_paths(p))
            logger.info("DATA_PATH %s: %d WSIs", p, n)
            if n == 0:
                logger.error("no WSIs found under DATA_PATH")
                ok = False
    if cfg.outroot:
        Path(cfg.outroot).mkdir(parents=True, exist_ok=True)
    return ok


def check_config(cfg, logger) -> bool:
    ok = True
    if not set(cfg.tme_classes).issubset(set(cfg.classes)):
        logger.error("TME_CLASSES must be a subset of classes")
        ok = False
    if cfg.patch_size <= 0 or cfg.embedding.batch_size <= 0:  # the reference's BATCH_SIZE
        logger.error("PATCH_SIZE and BATCH_SIZE must be positive")
        ok = False
    if cfg.thumb_size[0] <= 0 or cfg.thumb_size[1] <= 0:
        logger.error("THUMB_SIZE must be positive")
        ok = False
    if ok:
        logger.info("config invariants OK (%d classes, patch %d, batch %d)",
                    len(cfg.classes), cfg.patch_size, cfg.embedding.batch_size)
    return ok


def check_imports(logger) -> bool:
    ok = True
    for mod in PIPELINE_MODULES:
        try:
            importlib.import_module(mod)
        except Exception as e:
            logger.error("import failed: %s (%s)", mod, e)
            ok = False
    if ok:
        logger.info("all %d pipeline modules import", len(PIPELINE_MODULES))
    return ok


def check_accelerator(logger, require: bool = False) -> bool:
    import torch

    if torch.cuda.is_available():
        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        logger.info("CUDA devices: %s", names)
        return True
    logger.warning("no CUDA device — the pipeline runs only with --device cpu (slow)")
    return not require


def check_runtime_components(logger, require: bool = False) -> bool:
    """The tile decoder and the CLIP vocab warn when absent, as in the JAX
    package; the CUDA kernels fail the check only under ``require`` on a
    machine with a CUDA device (where a kernel that does not build or load
    would stop the pipeline), and warn otherwise."""
    import torch

    ok = True
    try:
        from path_gene_multimodal_tpu_torch.io.native import NativeTileDecoder, build_native

        logger.info("tile decoder built: %s", build_native())
        NativeTileDecoder()
    except Exception as e:
        logger.warning(
            "tile decoder unavailable (%s) — JPEG/deflate slides cannot be read; it builds "
            "with g++ (python -m path_gene_multimodal_tpu_torch.io.native)", e,
        )
    try:
        from path_gene_multimodal_tpu_torch.models.tokenizer import find_vocab_files

        found = find_vocab_files()
        if found:
            logger.info("CLIP vocab found: %s", {k: str(v) for k, v in found.items()})
        else:
            logger.warning(
                "CLIP vocab not found — zero-shot annotation would use the non-CLIP "
                "fallback tokenizer (degraded); see README for the one-command fetch recipe"
            )
    except Exception as e:
        logger.warning("vocab discovery failed: %s", e)
    try:
        from path_gene_multimodal_tpu_torch.ops import cuda

        cuda.build_all()
        for name in cuda.KERNELS:
            cuda.library(name)
        logger.info("CUDA kernels built and loaded: %s", ", ".join(cuda.KERNELS))
    except Exception as e:
        if require and torch.cuda.is_available():
            logger.error("CUDA kernels failed to build or load: %s", e)
            ok = False
        else:
            logger.warning("CUDA kernels unavailable (%s) — only --device cpu runs", e)
    return ok


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--require-accelerator", action="store_true")
    args = ap.parse_args(argv)
    logger = get_logger()
    cfg = default_config()
    if args.data_path:
        cfg = cfg.replace(data_path=args.data_path)
    results = [
        check_paths(cfg, logger),
        check_config(cfg, logger),
        check_imports(logger),
        check_runtime_components(logger, require=args.require_accelerator),
        check_accelerator(logger, require=args.require_accelerator),
    ]
    if all(results):
        logger.info("validation PASSED")
        return 0
    logger.error("validation FAILED")
    return 1


if __name__ == "__main__":
    sys.exit(main())
