"""End-to-end walkthrough, in the port — the reference's
``final_mussel.ipynb`` as a runnable script on a synthetic slide (no
external data or weights needed).

The JAX package's ``examples/full_pipeline_demo.py`` with its steps,
sizes and printed lines: synthetic WSI → tiled SVS on disk → 8-step
pipeline (tessellate → embed → class-embed → annotate → spatial/TME →
polygons → GeoJSON → overlays) → nuclei segmentation over the TME tiles →
molecular prediction → cell graph + stage-6 analysis → islands/burden
metrics.

On the card (the default) it takes the accelerator sizes: a 4096 x 3072
slide, CLIP ViT-B/16, HoverNeXt-tiny at its published widths (bf16: K1 in
the encoder's stages 0-2, the low-res final stage; K2-K4 in the
instance step) and the six IDaRS ResNet34s. With ``--device cpu`` it takes
the JAX package's CPU sizes: a 2048 x 1536 slide, embedding batch 64,
nuclei batch 8, a small HoverNeXt and ResNets of width 16 with one block
a stage. K5 labels the tissue mask in the islands step; the runner's
small-region removal, K5's other caller, is off (``area_min_tiles=0``, as
in the JAX demo).

Random weights are drawn from seeds, so predictions are plumbing-grade,
not biology — ``cli.convert_weights`` artifacts carry real checkpoints.
Exit 0 when the slide is done, 1 when the runner fails it, 2 without a
GPU unless ``--device cpu``.

Usage:
    python -m path_gene_multimodal_tpu_torch.cli.full_pipeline_demo [out_dir] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

STEM = "demo_case"
# what the JAX package's examples/full_pipeline_demo.py lists in the slide's
# directory, "{s}" for STEM (the per-class PNG aside, whose name follows the
# winning class)
ARTIFACTS = (
    "{s}._DONE.json", "{s}._steps.json", "{s}.geojson", "{s}.h5", "{s}_all_classes_overlay.png",
    "{s}_annotations.csv", "{s}_annotations_with_coords.csv", "{s}_boundaries.png",
    "{s}_braf_overlay.png", "{s}_cell_graph.npz", "{s}_cimp_overlay.png", "{s}_cin_overlay.png",
    "{s}_classes.npy", "{s}_classes.pt", "{s}_features.h5", "{s}_features.npy",
    "{s}_features.pt", "{s}_graph_node_stats.npz", "{s}_graph_stats.json",
    "{s}_hm_overlay.png", "{s}_hovernet_nuclei_wsi.csv", "{s}_hovernet_nuclei_wsi.parquet",
    "{s}_islands.csv", "{s}_metrics.txt", "{s}_molecular_features.csv",
    "{s}_molecular_grid.png", "{s}_msi_overlay.png", "{s}_tp53_overlay.png", "grid_mask.png",
    "mask.png", "thumbnail.png")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", nargs="?", default="demo_out")
    ap.add_argument("--device", default="cuda", help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    import shutil
    from dataclasses import replace as dc_replace

    import numpy as np
    import pandas as pd
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    out_root = Path(args.out_dir)
    out_root.mkdir(parents=True, exist_ok=True)

    from path_gene_multimodal_tpu_torch.config import (
        HOVERNEXT_TINY,
        ConvNeXtConfig,
        HoverNeXtConfig,
        default_config,
    )
    from path_gene_multimodal_tpu_torch.io.slide import open_slide, synthetic_wsi
    from path_gene_multimodal_tpu_torch.io.tiff_write import write_tiled_tiff
    from path_gene_multimodal_tpu_torch.models.resnet import IDaRSEnsemble, ResNetConfig
    from path_gene_multimodal_tpu_torch.pipeline import graph as graph_mod
    from path_gene_multimodal_tpu_torch.pipeline import graph_stats, molecular, morphology
    from path_gene_multimodal_tpu_torch.pipeline import nuclei as nuclei_mod
    from path_gene_multimodal_tpu_torch.pipeline import runner

    t0 = time.perf_counter()
    on_cpu = device.type == "cpu"
    slide_wh = (2048, 1536) if on_cpu else (4096, 3072)

    print(f"[1] synthesizing a slide and writing a real tiled SVS "
          f"({slide_wh[0]}x{slide_wh[1]}) ...")
    synth = synthetic_wsi(*slide_wh, seed=42, n_blobs=5, nuclei_per_blob=150)
    svs_path = out_root / f"{STEM}.svs"
    write_tiled_tiff(
        svs_path, [synth._levels[0], synth._levels[1], synth._levels[2]],
        tile_size=256, compression=7, description="Synthetic |MPP = 0.2500|",
    )

    print("[2] running the 8-step pipeline ...")
    cfg = default_config()
    cfg = cfg.replace(
        tme_classes=cfg.classes,  # random weights: any class seeds the ROI
        polygon=dc_replace(cfg.polygon, min_polygon_area_px=0, area_min_tiles=0),
    )
    if on_cpu:
        cfg = cfg.replace(
            embedding=dc_replace(cfg.embedding, batch_size=64),
            hovernext=dc_replace(cfg.hovernext, batch_size=8),
        )
    models = runner.PipelineModels.build(cfg, device=device)
    # a fresh demo each run: a previous done flag would skip every step
    if (out_root / STEM).exists():
        shutil.rmtree(out_root / STEM)
    result = runner.run_one_wsi(svs_path, out_root, cfg, models=models)
    print(f"    status={result.status} tiles={result.num_tiles} "
          f"polygons={result.num_polygons}")
    if result.status != "done":
        print(f"    error: {result.error}")
        return 1
    out_dir, stem = result.out_dir, result.stem
    ann_csv = out_dir / f"{stem}_annotations_with_coords.csv"

    print("[3] nuclei segmentation over TME tiles ...")
    slide = open_slide(svs_path)
    seg_cfg = HOVERNEXT_TINY
    if on_cpu:  # random weights either way: a small network keeps the CPU in seconds
        seg_cfg = HoverNeXtConfig(
            encoder=ConvNeXtConfig(depths=(1, 1, 2, 1), dims=(24, 48, 96, 192)),
            decoder_dims=(96, 48, 24, 16),
        )
    seg = nuclei_mod.NucleiModel.build(
        seg_cfg, tta=cfg.hovernext.tta, device=device,
        max_instances=cfg.hovernext.max_instances_per_tile,
    )
    nuclei = nuclei_mod.run_hovernet_pipeline_on_wsi_tiles(slide, ann_csv, out_dir, stem, seg, cfg)
    print(f"    {len(nuclei)} nuclei (random weights → usually 0)")

    print("[4] molecular (IDaRS) prediction ...")
    tasks = list(cfg.molecular.tasks)
    ensemble = (IDaRSEnsemble(tasks, cfg=ResNetConfig(stage_sizes=(1, 1, 1, 1), width=16),
                              device=device)
                if on_cpu else IDaRSEnsemble(tasks, device=device))
    mol = molecular.extract_molecular_features(slide, ann_csv, out_dir, stem, ensemble, cfg)
    print(f"    molecular columns: {[c for c in mol.features.columns if c.endswith('_prob')]}")

    print("[5] spatial cell graph ...")
    if len(nuclei) >= 2:
        graph = graph_mod.build_cell_graph(nuclei, cfg.graph, out_dir, stem, device=device)
        print(f"    {len(graph.node_ids)} nodes, {graph.edge_index.shape[1]} edges")
    else:
        # demo continuity with random weights: a synthetic nuclei table
        rng = np.random.default_rng(0)
        fake = pd.DataFrame(
            {
                "nuc_id": [f"n{i}" for i in range(500)],
                "type": rng.integers(1, 6, 500),
                "wsi_centroid_x": rng.uniform(0, slide_wh[0], 500),
                "wsi_centroid_y": rng.uniform(0, slide_wh[1], 500),
                "area": rng.uniform(40, 200, 500),
                "perimeter": rng.uniform(20, 70, 500),
                "eccentricity": rng.uniform(0, 0.9, 500),
                "solidity": rng.uniform(0.7, 1.0, 500),
                "major_axis_length": rng.uniform(8, 20, 500),
                "minor_axis_length": rng.uniform(4, 10, 500),
                "orientation": rng.uniform(-1.5, 1.5, 500),
            }
        )
        graph = graph_mod.build_cell_graph(fake, cfg.graph, out_dir, stem, device=device)
        print(f"    (synthetic table) {len(graph.node_ids)} nodes, "
              f"{graph.edge_index.shape[1]} edges")
    stats = graph_stats.analyze_graph(graph, out_dir, stem, n_perms=50)
    print(f"    stage-6 analysis: mean degree {stats['mean_degree']:.2f}, "
          f"mean clustering {stats['mean_clustering']:.3f}")

    print("[6] islands + burden metrics ...")
    classes = list(cfg.classes)
    islands = morphology.process_one_slide_make_csv_and_plot(
        slide, out_dir / f"{stem}.geojson", out_dir, stem,
        tumor_classes=classes[:2], til_classes=[classes[2]], tls_classes=[classes[3]],
        device=device,
    )
    morphology.write_basic_size_burden_metrics_txt(islands, stem, out_dir / f"{stem}_metrics.txt")
    slide.close()

    print(f"\nall artifacts in {out_dir} ({time.perf_counter() - t0:.0f}s):")
    for p in sorted(out_dir.iterdir()):
        print(f"  {p.name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
