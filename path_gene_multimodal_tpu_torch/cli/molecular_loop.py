"""Molecular batch loop — the reference's ``run_molecular_loop.py``, in the
port.

The JAX package's ``cli/molecular_loop.py`` with its arguments and
defaults: walks every WSI under the data path, skips slides without an
annotations CSV or already done (3-tier detection: the
``_DONE_MOLECULAR`` flag, the molecular CSV, or the msi overlay —
``run_molecular_loop.py:67-99``), runs ``extract_molecular_features``
per slide with a per-slide try/except, and appends to
``success_slides.txt`` / ``error_slides.txt`` with a flush (``:101-155``).
The IDaRS ensemble is built once for the whole loop. Exit 0 when every
slide was done or skipped, 1 when one failed, 2 on usage errors: no
slide under the data path, a ``--weights-dir`` artifact of another kind,
no GPU without ``--device cpu``, and a molecular batch that does not divide
the ``--dp`` mesh. ``--dp`` copies the six networks to every local device
(the CPU is one) and splits each tile batch over them.

A task without ``<task>.npz`` in ``--weights-dir`` (or every task, without
the option) runs on seeded random weights, drawn from a ``torch.Generator``
on the device seeded with ``zlib.crc32(task) % 2**31``: reproducible, and
not the JAX package's weights (its PRNG differs).

Usage:
    python -m path_gene_multimodal_tpu_torch.cli.molecular_loop --data-path D --outroot O
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import zlib
from pathlib import Path

from path_gene_multimodal_tpu_torch.config import (
    DEFAULT_MOLECULAR_TASKS,
    default_config,
    slide_paths,
)
from path_gene_multimodal_tpu_torch.utils.log import get_logger


def is_done(out_dir: Path, stem: str, cfg) -> bool:
    """3-tier done detection (run_molecular_loop.py:70-95)."""
    if (out_dir / f"{stem}.{cfg.done_flag_molecular.lstrip('.')}").exists():
        return True
    if (out_dir / f"{stem}_molecular_features.csv").exists():
        return True
    return (out_dir / f"{stem}_msi_overlay.png").exists()


def write_done_flag(out_dir: Path, stem: str, cfg) -> None:
    (out_dir / f"{stem}.{cfg.done_flag_molecular.lstrip('.')}").write_text(
        json.dumps({"status": "done", "timestamp": time.time()}))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--outroot", default=None)
    ap.add_argument("--tasks", nargs="*", default=None,
                    help=f"subset of {list(DEFAULT_MOLECULAR_TASKS)}")
    ap.add_argument(
        "--weights-dir", default=None, metavar="DIR",
        help="directory of converted resnet34 artifacts named <task>.npz "
             "(cli.convert_weights kind=resnet34, one per resnet34-idars-* "
             "checkpoint); tasks without a file run with RANDOM weights",
    )
    ap.add_argument(
        "--dp", action="store_true",
        help="data-parallel inference: replicate the ensemble's weights and shard each "
             "tile batch over a tile-axis mesh of all local devices "
             "(the molecular batch size must be a multiple of the device count)",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    logger = get_logger()
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        logger.error("no CUDA device: pass --device cpu to run on the CPU")
        return 2
    cfg = default_config()
    data_path = Path(args.data_path or cfg.data_path)
    outroot = Path(args.outroot or cfg.outroot or "out")
    tasks = args.tasks or list(cfg.molecular.tasks)

    from path_gene_multimodal_tpu_torch.io.slide import open_slide
    from path_gene_multimodal_tpu_torch.models.resnet import (
        RESNET34_IDARS,
        IDaRSEnsemble,
        seeded_resnet,
    )
    from path_gene_multimodal_tpu_torch.pipeline.molecular import extract_molecular_features

    loaded: dict = {}
    if args.weights_dir:
        from path_gene_multimodal_tpu_torch.core.checkpoints import load_converted
        from path_gene_multimodal_tpu_torch.models.weights_resnet import (
            infer_resnet_config,
            resnet_state_dict_from_jax,
        )

        for t in tasks:
            f = Path(args.weights_dir) / f"{t}.npz"
            if not f.exists():
                continue
            kind, _, variables = load_converted(f)
            if kind != "resnet34":
                logger.error("%s is a %r artifact, expected resnet34", f, kind)
                return 2
            rcfg = infer_resnet_config(variables)
            loaded[t] = (rcfg, resnet_state_dict_from_jax(variables, rcfg))
            logger.info("loaded %s weights from %s", t, f)
    configs = {c for c, _ in loaded.values()}
    if len(configs) > 1:
        logger.error("the --weights-dir artifacts have different shapes: %s", configs)
        return 2
    rcfg = configs.pop() if configs else RESNET34_IDARS
    state_dicts = []
    for t in tasks:
        if t in loaded:
            state_dicts.append(loaded[t][1])
        else:
            # crc32, not hash(): PYTHONHASHSEED randomizes str hashes per process
            logger.warning("%s: no converted weights — RANDOM weights for this task", t)
            net = seeded_resnet(rcfg, zlib.crc32(t.encode()) % 2**31, device=device)
            state_dicts.append(net.state_dict())
    mesh = None
    if args.dp:
        from path_gene_multimodal_tpu_torch.parallel.mesh import dp_mesh_for_batch

        try:
            mesh = dp_mesh_for_batch(cfg.molecular.batch_size, config=cfg.mesh, logger=logger,
                                     label="molecular batch", device=device)
        except ValueError as e:
            logger.error("%s", e)
            return 2
    # built ONCE for the loop
    ensemble = IDaRSEnsemble(tasks, state_dicts, cfg=rcfg, device=device, mesh=mesh)
    wsis = slide_paths(data_path)
    if not wsis:
        logger.error("no WSIs under %s", data_path)
        return 2
    outroot.mkdir(parents=True, exist_ok=True)
    n_ok = n_skip = n_err = 0
    with (outroot / "success_slides.txt").open("a") as success_log, \
            (outroot / "error_slides.txt").open("a") as error_log:
        for wsi in wsis:
            stem = wsi.stem
            out_dir = outroot / stem
            csv = out_dir / f"{stem}_annotations_with_coords.csv"
            if not csv.exists():
                logger.info("skip %s: no annotations CSV", stem)
                n_skip += 1
                continue
            if is_done(out_dir, stem, cfg):
                logger.info("skip %s: already done", stem)
                n_skip += 1
                continue
            try:
                slide = open_slide(wsi)
                extract_molecular_features(slide, csv, out_dir, stem, ensemble, cfg)
                write_done_flag(out_dir, stem, cfg)
                success_log.write(f"{stem}\n")
                success_log.flush()
                n_ok += 1
            except Exception:  # per-slide boundary: record, report, go on
                error_log.write(f"{stem}\n{traceback.format_exc()}\n")
                error_log.flush()
                logger.exception("slide %s failed", stem)
                n_err += 1
    logger.info("molecular loop: %d ok, %d skipped, %d errors", n_ok, n_skip, n_err)
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
