"""Standalone HoverNeXt inference CLI — the reference's
``hovernet_inference.py`` script entry, on the card.

    python -m path_gene_multimodal_tpu_torch.cli.hovernext_infer \\
        --input slide.svs --output out/ [--checkpoint sd.pt] [--device cpu]

Two modes, matching the reference's input types (``get_input_type``):

- ``--mode wsi`` (canonical): sliding-window whole-slide segmentation
  (window 256, stride = window × overlap — the script-config
  ``tile_size=256, overlap=0.96875``), producing the slide-scale instance
  map + nuclei table (``pipeline/nuclei_wsi.py``);
- ``--mode tiles``: per-tile run over TME-ROI tiles from an annotations
  CSV (``pipeline/nuclei.py``, the ``aggregated_hovernet_run`` path).

Reference-named knobs: ``--tile-size``, ``--overlap``, ``--tta``,
``--batch-size``; weights from ``--checkpoint`` (a torch state dict in the
published smp/timm hover_next layout or the canonical one, or a ``.npz``
written by the JAX package's ``cli.convert_weights``, kind hovernext),
random otherwise (logged). The model is bf16, as the JAX package builds
it: the published layout as ``RealNucleiModel`` (plain encoder, smp
decoders), the canonical one as ``NucleiModel`` (K1 blocks and the
low-res final stage). It runs on the card (``--device cuda``, the default)
and exits with an error without one; ``--device cpu`` runs the kernels'
plain versions. ``--dp`` builds the model on every local device (the CPU
is one) and splits each batch over them, in both modes and both layouts;
a ``--batch-size`` that does not divide that mesh exits 2.
"""

from __future__ import annotations

import argparse
import glob
import sys
import time
from dataclasses import replace
from pathlib import Path

from path_gene_multimodal_tpu_torch.utils.log import StageTimer, get_logger


def resolve_inputs(spec: str) -> list[Path]:
    """Reference ``prepare_input`` semantics (hovernet_inference.py:22-59):
    a ``.txt`` file = one input path per line; anything else is a glob
    pattern (a plain existing path matches itself). Raises on empty lists
    and unmatched patterns as the reference does."""
    if spec.endswith(".txt"):
        p = Path(spec)
        if not p.exists():
            raise FileNotFoundError(f"input text file not found: {spec}")
        inputs = [Path(s.strip()) for s in p.read_text().splitlines() if s.strip()]
        if not inputs:
            raise ValueError(f"{spec} is empty or contains no valid paths")
        return inputs
    matches = sorted(glob.glob(spec.rstrip()))
    if not matches:
        raise ValueError(f"no files found matching pattern: {spec}")
    return [Path(m) for m in matches]


def _unique_stems(inputs: list[Path], logger) -> list[str]:
    """Duplicate stems across directories (cohortA/case7.svs +
    cohortB/case7.svs) get a numeric suffix, so that one slide's
    artifacts never overwrite another's."""
    stems: list[str] = []
    seen: dict[str, int] = {}
    for wsi in inputs:
        n = seen.get(wsi.stem, 0)
        seen[wsi.stem] = n + 1
        stems.append(wsi.stem if n == 0 else f"{wsi.stem}_{n + 1}")
        if n == 1:
            logger.warning("duplicate input stem %r: later inputs write under %s_2, %s_3, ...",
                           wsi.stem, wsi.stem, wsi.stem)
    return stems


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--input", required=True,
        help="WSI/image/.npy path, a glob pattern, or a .txt list of paths "
             "(one per line) — the reference's prepare_input surface",
    )
    ap.add_argument("--output", required=True, help="output directory")
    ap.add_argument("--mode", choices=["wsi", "tiles"], default="wsi")
    ap.add_argument("--annotations-csv", default=None, help="required for --mode tiles")
    ap.add_argument(
        "--checkpoint", default=None,
        help="torch state dict in the published hover_next layout or the canonical "
             "HoverNeXt one, or a .npz converted-checkpoint artifact (kind=hovernext)",
    )
    ap.add_argument(
        "--allow-pickle", action="store_true",
        help="permit full unpickling for trusted checkpoints that weights_only "
             "loading cannot read (unpickling can execute code)",
    )
    ap.add_argument("--tile-size", type=int, default=256)
    ap.add_argument("--overlap", type=float, default=0.96875)
    ap.add_argument("--tta", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--only-inference", action="store_true",
                    help="skip artifacts; report timings only")
    ap.add_argument(
        "--exact-gelu", action="store_true",
        help="use the reference's exact-erf GELU (torch nn.GELU) instead of the "
             "default tanh approximation",
    )
    ap.add_argument(
        "--dp", action="store_true",
        help="data-parallel inference: replicate the model's weights and shard each "
             "window batch over a tile-axis mesh of all local devices "
             "(--batch-size must be a multiple of the device count)",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)
    logger = get_logger()
    # usage errors fail before any model is built
    if args.mode == "tiles" and not args.annotations_csv:
        logger.error("--mode tiles requires --annotations-csv")
        return 2
    try:
        inputs = resolve_inputs(args.input)
    except (FileNotFoundError, ValueError) as e:
        logger.error("%s", e)
        return 2
    missing = [p for p in inputs if not p.exists()]
    if missing:
        logger.error("input not found: %s", ", ".join(map(str, missing)))
        return 2
    if args.mode == "tiles" and len(inputs) > 1:
        logger.error("--mode tiles takes a single input (got %d; one --annotations-csv "
                     "cannot describe several slides)", len(inputs))
        return 2

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        logger.error("no CUDA device: pass --device cpu to run on the CPU")
        return 2

    from path_gene_multimodal_tpu_torch.config import (
        HoverNeXtConfig,
        RealHoverNeXtConfig,
        default_config,
    )
    from path_gene_multimodal_tpu_torch.io.slide import open_slide
    from path_gene_multimodal_tpu_torch.pipeline.nuclei import (
        NucleiModel,
        RealNucleiModel,
        run_hovernet_pipeline_on_wsi_tiles,
    )
    from path_gene_multimodal_tpu_torch.pipeline.nuclei_wsi import run_hovernext_wsi

    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = default_config()
    cfg = replace(cfg, hovernext=replace(
        cfg.hovernext, tile_size=args.tile_size, overlap=args.overlap, tta=args.tta,
        batch_size=args.batch_size))

    mcfg = HoverNeXtConfig(input_size=cfg.hovernext.tile_size)
    state_dict = None
    real = False
    if args.checkpoint:
        from path_gene_multimodal_tpu_torch.core.checkpoints import (
            load_converted,
            load_hovernext_from_torch,
        )

        if args.checkpoint.endswith(".npz"):
            kind, loaded_cfg, params = load_converted(args.checkpoint)
            if kind != "hovernext":
                logger.error("%s is a %r artifact, expected kind=hovernext",
                             args.checkpoint, kind)
                return 2
            if isinstance(loaded_cfg, RealHoverNeXtConfig):
                from path_gene_multimodal_tpu_torch.models.weights_hovernext_real import (
                    real_state_dict_from_jax as from_jax,
                )
            else:
                from path_gene_multimodal_tpu_torch.models.weights_hovernext import (
                    params_from_jax as from_jax,
                )
            state_dict = from_jax(params, loaded_cfg)
        else:
            loaded_cfg, state_dict = load_hovernext_from_torch(
                args.checkpoint, allow_pickle=args.allow_pickle)
        mcfg = replace(loaded_cfg, input_size=cfg.hovernext.tile_size)
        real = isinstance(loaded_cfg, RealHoverNeXtConfig)
        if real:
            logger.info("loaded REAL-layout hover_next from %s (encoder dims %s, branches %s)",
                        args.checkpoint, mcfg.encoder.dims, mcfg.branches)
        else:
            logger.info("loaded pretrained HoverNeXt from %s (encoder dims %s, %d types)",
                        args.checkpoint, mcfg.encoder.dims, mcfg.num_types)
    else:
        logger.warning("no --checkpoint given: running with RANDOM weights "
                       "(plumbing/benchmark mode, not biology)")
    if args.exact_gelu:
        mcfg = replace(mcfg, encoder=replace(mcfg.encoder, exact_gelu=True))
    mesh = None
    if args.dp:
        from path_gene_multimodal_tpu_torch.parallel.mesh import dp_mesh_for_batch

        try:
            mesh = dp_mesh_for_batch(args.batch_size, config=cfg.mesh, logger=logger,
                                     label="--batch-size", device=device)
        except ValueError as e:
            logger.error("%s", e)
            return 2
    # one model for the whole input list (the reference rebuilt it per input)
    model = (RealNucleiModel if real else NucleiModel).build(
        mcfg, state_dict=state_dict, tta=args.tta, dtype=torch.bfloat16, device=device,
        mesh=mesh, max_instances=cfg.hovernext.max_instances_per_tile)

    stems = _unique_stems(inputs, logger)
    failed = 0
    for wsi, stem in zip(inputs, stems):
        dest = out_dir if len(inputs) == 1 else out_dir / stem
        dest.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        timer = StageTimer()
        try:
            slide = open_slide(wsi)
            try:
                if args.mode == "wsi":
                    _, nuclei = run_hovernext_wsi(
                        slide, dest, stem, model, cfg, batch_size=args.batch_size,
                        write_artifacts=not args.only_inference, timer=timer)
                else:
                    with timer.stage("hovernext_tiles"):
                        nuclei = run_hovernet_pipeline_on_wsi_tiles(
                            slide, args.annotations_csv, dest, stem, model, cfg,
                            batch_size=args.batch_size,
                            write_artifacts=not args.only_inference)
            finally:
                close = getattr(slide, "close", None)
                if close is not None:
                    close()
        except Exception as e:
            # one corrupt slide must not abort a long list (the reference's
            # batch loops fail soft the same way); a single input re-raises
            if len(inputs) == 1:
                raise
            failed += 1
            logger.error("%s: FAILED (%s: %s) — continuing", wsi, type(e).__name__, e)
            continue
        logger.info("%s: inference+postproc: %d nuclei in %.1fs", stem, len(nuclei),
                    time.perf_counter() - t0)
        logger.info("%s: stage report %s", stem, timer.report())
    if failed:
        logger.error("%d/%d inputs failed", failed, len(inputs))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
