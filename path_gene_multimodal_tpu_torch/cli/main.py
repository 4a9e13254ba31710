"""Primary CLI — the reference's ``main.py`` entry point, in the port.

The JAX package's ``cli/main.py`` with its arguments and exit codes: the
slide comes from ``--wsi`` or the ``WSI_PATH`` environment variable (set
per task by an LSF/Slurm array job); the output root from ``--outroot``
(else the config's, else ``out``). Lock/done/error files coordinate a
fleet of independent workers over a shared filesystem. Exit 0 when the
slide is done (or was already), 1 when it failed (its ``_ERROR.txt`` says
why), 2 on usage errors: no slide, a missing or unsupported slide path, a
weights artifact of another kind or whose params do not fit its config, no
GPU without ``--device cpu``, and an embedding batch that does not divide
the ``--dp`` mesh. ``--dp`` replicates the image tower on every local
device (the CPU is one) and splits each embedding batch over them.
``--weights`` takes a converted CLIP tower or a
converted timm Virchow2 tower (ViT-H/14, 2560-d embeddings; steps 3-4 then
score it against the 512-d CLIP text tower as the JAX package does, which
fails at step 4).

Usage:
    WSI_PATH=/data/slide.svs python -m path_gene_multimodal_tpu_torch.cli.main
    python -m path_gene_multimodal_tpu_torch.cli.main --wsi slide.svs --outroot out/
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from pathlib import Path

from path_gene_multimodal_tpu_torch.config import WSI_EXTS, default_config
from path_gene_multimodal_tpu_torch.pipeline.runner import PipelineModels, run_one_wsi
from path_gene_multimodal_tpu_torch.utils.log import get_logger


def validate_wsi_path(wsi_path: str | Path) -> Path:
    """Existence + extension check (reference main.py:129-140)."""
    p = Path(wsi_path)
    if not p.exists():
        raise FileNotFoundError(f"WSI not found: {p}")
    if p.suffix.lower() not in WSI_EXTS | {".npz"}:
        raise ValueError(
            f"unsupported WSI extension {p.suffix!r} (expected one of {sorted(WSI_EXTS)})"
        )
    return p


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wsi", default=None, help="slide path (default: $WSI_PATH)")
    ap.add_argument("--outroot", default=None, help="output root directory")
    ap.add_argument("--no-locks", action="store_true", help="skip lock files")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the run into DIR")
    ap.add_argument(
        "--weights", default=None, metavar="NPZ",
        help="converted image-tower checkpoint from cli.convert_weights "
             "(kind clip, or virchow2: the timm tower or a CLIP-style config); CLIP text weights "
             "auto-load from <stem>_text.npz next to it. Without it the towers run "
             "with RANDOM weights (plumbing mode).",
    )
    ap.add_argument(
        "--dp", action="store_true",
        help="data-parallel embedding: replicate the image tower and shard "
             "each tile batch over a tile-axis mesh of all local devices "
             "(the embedding batch size must be a multiple of the device count)",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)

    logger = get_logger()
    wsi = args.wsi or os.environ.get("WSI_PATH")
    if not wsi:
        logger.error("no slide given: set WSI_PATH or pass --wsi")
        return 2
    cfg = default_config()
    outroot = args.outroot or cfg.outroot or "out"
    try:
        wsi_path = validate_wsi_path(wsi)
    except (FileNotFoundError, ValueError) as e:
        logger.error("%s", e)
        return 2

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        logger.error("no CUDA device: pass --device cpu to run on the CPU")
        return 2

    vision_cfg = vision_sd = text_cfg = text_sd = None
    weights_fp = None
    if args.weights:
        from path_gene_multimodal_tpu_torch.core.checkpoints import (
            file_fingerprint,
            load_converted,
            text_sidecar_path,
        )
        from path_gene_multimodal_tpu_torch.models.vit_timm import TimmViTConfig
        from path_gene_multimodal_tpu_torch.models.weights_clip import (
            text_state_dict_from_jax,
            vision_state_dict_from_jax,
        )
        from path_gene_multimodal_tpu_torch.models.weights_vit_timm import (
            timm_state_dict_from_jax,
        )

        weights_fp = file_fingerprint(args.weights)
        try:
            kind, vision_cfg, params = load_converted(args.weights)
        except ValueError as e:
            logger.error("%s: %s", args.weights, e)
            return 2
        if kind not in ("clip", "virchow2"):
            logger.error("%s is a %r artifact, expected kind clip|virchow2", args.weights, kind)
            return 2
        to_sd = (timm_state_dict_from_jax if isinstance(vision_cfg, TimmViTConfig)
                 else vision_state_dict_from_jax)
        try:
            vision_sd = to_sd(params, vision_cfg)
        except KeyError as e:
            logger.error("%s: its params do not fit its %s config (no %s)", args.weights, kind, e)
            return 2
        tfile = text_sidecar_path(args.weights)
        if tfile.exists():
            _, text_cfg, tparams = load_converted(tfile)
            text_sd = text_state_dict_from_jax(tparams, text_cfg)
            logger.info("loaded text tower from %s", tfile)
        logger.info("loaded %s image tower from %s", kind, args.weights)
    mesh = None
    if args.dp:
        from path_gene_multimodal_tpu_torch.parallel.mesh import dp_mesh_for_batch

        try:
            mesh = dp_mesh_for_batch(cfg.embedding.batch_size, config=cfg.mesh, logger=logger,
                                     label="embedding batch", device=device)
        except ValueError as e:
            logger.error("%s", e)
            return 2
    models = PipelineModels.build(
        cfg, vision_state_dict=vision_sd, vision_cfg=vision_cfg, text_cfg=text_cfg,
        text_state_dict=text_sd, weights_fingerprint=weights_fp, device=device, mesh=mesh,
    )
    profile_ctx = contextlib.nullcontext()
    if args.profile:
        act = torch.profiler.ProfilerActivity
        activities = [act.CPU] + ([act.CUDA] if device.type == "cuda" else [])
        Path(args.profile).mkdir(parents=True, exist_ok=True)
        profile_ctx = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(args.profile))
    with profile_ctx:
        result = run_one_wsi(wsi_path, outroot, cfg, models=models,
                             use_locks=not args.no_locks)
    logger.info("slide %s: %s (%d tiles, %d polygons)",
                result.stem, result.status, result.num_tiles, result.num_polygons)
    return 0 if result.status in ("done", "already_done") else 1


if __name__ == "__main__":
    sys.exit(main())
