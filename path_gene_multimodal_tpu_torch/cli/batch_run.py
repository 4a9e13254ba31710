"""Multi-slide batch runner for the 8-step pipeline, in the port.

The JAX package's ``cli/batch_run.py`` with its arguments: loop a slide
list (``--slide-list``, one path a line, else every WSI under
``--data-path``) with ONE long-lived model bundle (no per-slide rebuilds),
honour the lock/done protocol of ``run_one_wsi`` so that it can run beside
array-job workers on a shared filesystem, and append ``success_slides.txt``
and ``error_slides.txt`` under the output root. ``--dp`` replicates the
image tower on every local device (the CPU is one) and splits each
embedding batch over them. Exit 0 when no slide failed, 1 when one did, 2
on usage errors: no slide to process, no GPU without ``--device cpu``, an
embedding batch that does not divide the ``--dp`` mesh.

Usage:
    python -m path_gene_multimodal_tpu_torch.cli.batch_run --data-path D --outroot O
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from path_gene_multimodal_tpu_torch.config import default_config, slide_paths
from path_gene_multimodal_tpu_torch.utils.log import get_logger


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-path", default=None, help="directory of WSIs")
    ap.add_argument("--slide-list", default=None, help="file with one WSI path per line")
    ap.add_argument("--outroot", default=None)
    ap.add_argument("--no-locks", action="store_true")
    ap.add_argument("--limit", type=int, default=None, help="max slides this run")
    ap.add_argument(
        "--dp", action="store_true",
        help="data-parallel embedding over a tile-axis mesh of all local "
             "devices (same flag as cli.main --dp)",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)

    logger = get_logger()
    cfg = default_config()
    outroot = Path(args.outroot or cfg.outroot or "out")
    if args.slide_list:
        wsis = [Path(line.strip()) for line in Path(args.slide_list).read_text().splitlines()
                if line.strip()]
    else:
        wsis = slide_paths(args.data_path or cfg.data_path)
    if not wsis:
        logger.error("no slides to process")
        return 2
    if args.limit is not None:  # `if args.limit:` would make --limit 0 = ALL
        wsis = wsis[: args.limit]

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        logger.error("no CUDA device: pass --device cpu to run on the CPU")
        return 2

    from path_gene_multimodal_tpu_torch.pipeline.runner import PipelineModels, run_one_wsi

    mesh = None
    if args.dp:
        from path_gene_multimodal_tpu_torch.parallel.mesh import dp_mesh_for_batch

        try:
            mesh = dp_mesh_for_batch(cfg.embedding.batch_size, config=cfg.mesh, logger=logger,
                                     label="embedding batch", device=device)
        except ValueError as e:
            logger.error("%s", e)
            return 2
    models = PipelineModels.build(cfg, device=device, mesh=mesh)  # once for the whole batch
    outroot.mkdir(parents=True, exist_ok=True)
    counts = {"done": 0, "already_done": 0, "locked": 0, "error": 0}
    with open(outroot / "success_slides.txt", "a") as success_log, \
            open(outroot / "error_slides.txt", "a") as error_log:
        for wsi in wsis:
            result = run_one_wsi(wsi, outroot, cfg, models=models, use_locks=not args.no_locks)
            counts[result.status] = counts.get(result.status, 0) + 1
            if result.status == "done":
                success_log.write(f"{result.stem}\n")
                success_log.flush()
            elif result.status == "error":
                error_log.write(f"{result.stem}\t{result.error}\n")
                error_log.flush()
    logger.info("batch done: %s", counts)
    return 0 if counts["error"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
