"""The canonical 8-step per-slide pipeline (reference ``main.py:143-317``
``run_one_wsi``), with the reference's lock/done/error protocol and
step-granular resume on top: the JAX package's ``pipeline/runner.py`` in
the port.

Steps (numbered exactly like the reference's ``[N/8]`` logs):
1. tessellation (tissue seg + tiling)          → <stem>.h5, mask/thumb PNGs
2. tile feature extraction                     → <stem>_features.h5
3. class text embeddings                       → <stem>_classes.npy
4. zero-shot annotation                        → <stem>_annotations.csv
5. spatial join + TME ROI                      → <stem>_annotations_with_coords.csv
6. polygon construction                        (in memory)
7. GeoJSON export                              → <stem>.geojson
8. thumbnail overlays                          → <stem>_all_classes_overlay.png + <class>.png

The device work runs on ``models.device`` (the card unless the models were
built with ``device="cpu"``): the tissue mask and tile fractions, both
towers, the cosine scores, the TME distances and the polygon grids (K5
labels each class's grid on the card). The models are built once per
process (``PipelineModels``), not per slide; with a ``mesh``
(``parallel/mesh.py``) the image tower is replicated over it and each
embedding batch split over its shards, and the rest runs on its first
device.
"""

from __future__ import annotations

import glob as _glob
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import torch

from path_gene_multimodal_tpu_torch.config import PipelineConfig
from path_gene_multimodal_tpu_torch.core.artifacts import read_features_h5, read_tessellation_h5
from path_gene_multimodal_tpu_torch.core.jobs import (
    SlideJob,
    already_done,
    mark_step_done,
    release_lock,
    step_is_done,
    try_acquire_lock,
    write_done_flag,
    write_error_file,
)
from path_gene_multimodal_tpu_torch.io.slide import SlideReader, open_slide
from path_gene_multimodal_tpu_torch.models.clip import (
    CLIP_MEAN,
    CLIP_STD,
    CLIP_TEXT,
    CLIP_VIT_B16,
    IMAGENET_MEAN,
    IMAGENET_STD,
    VIRCHOW2,
    ImageEncoder,
    TextConfig,
    TextEncoder,
    VisionConfig,
)
from path_gene_multimodal_tpu_torch.models.tokenizer import open_tokenizer
from path_gene_multimodal_tpu_torch.models.vit_timm import TimmViTConfig
from path_gene_multimodal_tpu_torch.parallel.mesh import Mesh
from path_gene_multimodal_tpu_torch.pipeline import embed as embed_stage
from path_gene_multimodal_tpu_torch.pipeline import overlay as overlay_stage
from path_gene_multimodal_tpu_torch.pipeline import polygons as polygon_stage
from path_gene_multimodal_tpu_torch.pipeline import spatial as spatial_stage
from path_gene_multimodal_tpu_torch.pipeline import tessellate as tess_stage
from path_gene_multimodal_tpu_torch.utils.log import StageTimer, get_logger

@dataclass
class PipelineModels:
    """Long-lived model bundle (weights on the device), built once."""

    image_encoder: ImageEncoder
    text_encoder: TextEncoder
    tokenizer: Any
    #: identity of the loaded weights — mixed into the step-resume manifest
    #: hash so features produced by DIFFERENT weights are never reused
    #: (cfg.content_hash() alone cannot see the params)
    fingerprint: str = "random-0"

    @property
    def device(self) -> torch.device:
        return self.image_encoder.device

    @classmethod
    def build(
        cls,
        cfg: PipelineConfig,
        vision_state_dict: dict | None = None,
        text_state_dict: dict | None = None,
        vision_cfg: VisionConfig | TimmViTConfig | None = None,
        text_cfg: TextConfig | None = None,
        tokenizer=None,
        seed: int = 0,
        weights_fingerprint: str | None = None,
        device: str | torch.device = "cuda",
        mesh: Mesh | None = None,
    ) -> "PipelineModels":
        """The towers on ``device``: ``vision_cfg`` (default CLIP ViT-B/16,
        or the CLIP-style Virchow2 stand-in when ``cfg.model_type`` starts
        with "virchow"; a ``TimmViTConfig`` is the real Virchow2 tower) in
        ``cfg.embedding.dtype``, the text tower in f32; state dicts in the
        port's names, else seeded random weights (``seed``, ``seed + 1``).
        Either Virchow2 tower normalizes with the ImageNet statistics. With
        a ``mesh``, the image tower runs over it and the text tower on its
        first device (``device`` is then that one)."""
        if mesh is not None:
            device = mesh.devices[0]
        virchow = cfg.model_type.lower().startswith("virchow")
        if vision_cfg is None:
            vision_cfg = VIRCHOW2 if virchow else CLIP_VIT_B16
        imagenet = virchow or isinstance(vision_cfg, TimmViTConfig)
        text_cfg = text_cfg or CLIP_TEXT
        dtype = torch.bfloat16 if cfg.embedding.dtype == "bfloat16" else torch.float32
        return cls(
            image_encoder=ImageEncoder(
                vision_cfg, state_dict=vision_state_dict, dtype=dtype, seed=seed,
                mean=IMAGENET_MEAN if imagenet else CLIP_MEAN,
                std=IMAGENET_STD if imagenet else CLIP_STD, device=device, mesh=mesh,
            ),
            text_encoder=TextEncoder(text_cfg, state_dict=text_state_dict, seed=seed + 1,
                                     device=device),
            tokenizer=tokenizer or open_tokenizer(),
            fingerprint=(
                weights_fingerprint
                if weights_fingerprint is not None
                else (f"random-{seed}" if vision_state_dict is None else "loaded-params")
            ),
        )


@dataclass
class RunResult:
    stem: str
    out_dir: Path
    status: str
    num_tiles: int = 0
    num_features: int = 0
    num_polygons: int = 0
    artifacts: dict = field(default_factory=dict)
    stage_report: dict = field(default_factory=dict)
    error: str | None = None


def run_one_wsi(
    wsi_path: str | Path,
    out_root: str | Path,
    cfg: PipelineConfig,
    models: PipelineModels | None = None,
    slide: SlideReader | None = None,
    use_locks: bool = True,
    device: str | torch.device = "cuda",
) -> RunResult:
    """Process one slide through all 8 steps. Per-slide output dir =
    ``<out_root>/<stem>/`` (reference layout). ``device`` places models
    this call builds; given ``models``, their device is used."""
    logger = get_logger()
    wsi_path = Path(wsi_path)
    stem = wsi_path.stem
    out_dir = Path(out_root) / stem
    job = SlideJob(
        wsi_path=wsi_path, out_dir=out_dir,
        done_flag_name=cfg.done_flag_name, stale_hours=cfg.stale_lock_hours,
    )

    esc = _glob.escape(stem)  # stems like "case[1]" must match literally
    # overlay fallback glob matches the reference name
    # (<stem>_all_classes_overlay.png) and the legacy <stem>_overlay_all.png
    if already_done(job, fallback_globs=(f"{esc}_*overlay*.png", f"{esc}.geojson")):
        logger.info("skip %s: already done", stem)
        return RunResult(stem=stem, out_dir=out_dir, status="already_done")
    if use_locks and not try_acquire_lock(job):
        logger.info("skip %s: locked by another worker", stem)
        return RunResult(stem=stem, out_dir=out_dir, status="locked")

    timer = StageTimer()
    opened_here = slide is None
    try:
        if slide is None:
            slide = open_slide(wsi_path)
        if models is None:
            models = PipelineModels.build(cfg, device=device)
        dev = models.device
        classes = list(cfg.classes)

        # step-granular resume: the two expensive steps skip when their
        # manifest entry matches the config hash and the artifacts still
        # exist; later steps are cheap and re-run. The models fingerprint
        # rides along so features from different weights are never reused.
        cfg_hash = f"{cfg.content_hash()}-{models.fingerprint}"
        with timer.stage("tessellation", step=(1, 8)) as info:
            h5_path = out_dir / f"{stem}.h5"
            if step_is_done(job, "tessellation", cfg_hash):
                coords = read_tessellation_h5(h5_path)["coords"]
                info["resumed"] = True
                logger.info("resume: tessellation manifest hit (%d tiles)", len(coords))
            else:
                tess = tess_stage.run_tessellation(slide, out_dir, cfg, stem=stem, device=dev)
                coords = tess.coords
                mark_step_done(job, "tessellation", cfg_hash, [h5_path])
            info["items"] = len(coords)
        if len(coords) == 0:
            raise ValueError(f"no foreground tiles found in {wsi_path}")

        with timer.stage("extract_features", step=(2, 8)) as info:
            feats_path = out_dir / f"{stem}_features.h5"
            if step_is_done(job, "extract_features", cfg_hash):
                feats = read_features_h5(feats_path)["features"]
                info["resumed"] = True
                logger.info("resume: features manifest hit (%d)", len(feats))
            else:
                feats = embed_stage.run_extract_features(
                    slide, coords, models.image_encoder, out_dir, stem, cfg
                )
                mark_step_done(job, "extract_features", cfg_hash, [feats_path])
            info["items"] = len(feats)

        features, geojson_path = run_steps_3_to_7(feats, models, cfg, out_dir, stem, timer)

        with timer.stage("overlays", step=(8, 8)):
            ov = overlay_stage.run_overlays(
                slide, features, classes, out_dir, stem, thumb_size=cfg.thumb_size
            )

        artifacts = {
            "wsi_path": str(wsi_path),
            "out_dir": str(out_dir),
            "csv_path": str(out_dir / f"{stem}_annotations_with_coords.csv"),
            "geojson_path": str(geojson_path),
            "overlay_all_path": str(ov["overlay_all_path"]),
            "per_class_outputs": {k: str(v) for k, v in ov["per_class_outputs"].items()},
        }
        write_done_flag(
            job,
            {
                **artifacts,
                "num_features": len(feats),
                "num_tiles": len(coords),
                "classes_processed": classes,
                "patch_size": cfg.patch_size,
                "model_type": cfg.model_type,
                "stage_report": timer.report(),
            },
        )
        return RunResult(
            stem=stem, out_dir=out_dir, status="done",
            num_tiles=len(coords), num_features=len(feats),
            num_polygons=len(features), artifacts=artifacts,
            stage_report=timer.report(),
        )
    except Exception as exc:  # per-slide failure → error file (main.py:341-353)
        write_error_file(job, exc)
        logger.exception("slide %s failed", stem)
        return RunResult(
            stem=stem, out_dir=out_dir, status="error", error=repr(exc),
            stage_report=timer.report(),
        )
    finally:
        if opened_here and slide is not None:
            # release the slide's file descriptor: batch loops process
            # thousands of slides per process and must not rely on GC
            getattr(slide, "close", lambda: None)()
        if use_locks:
            release_lock(job)


def run_steps_3_to_7(feats, models: PipelineModels, cfg: PipelineConfig, out_dir: Path,
                     stem: str, timer: StageTimer | None = None):
    """Steps 3-7 from the slide's features (step 1's H5 must be in
    ``out_dir``): class embeddings, annotation, spatial join + TME ROI,
    polygons, GeoJSON, on ``models.device``. Returns (polygon features,
    GeoJSON path)."""
    timer = timer or StageTimer()
    dev = models.device
    classes = list(cfg.classes)
    with timer.stage("class_embeddings", step=(3, 8)):
        class_embs = embed_stage.run_create_class_embeddings(
            classes, models.text_encoder, models.tokenizer, out_dir, stem
        )
    with timer.stage("annotation", step=(4, 8)) as info:
        embed_stage.run_annotation(feats, class_embs, classes, out_dir, stem, device=dev)
        info["items"] = len(feats)
    with timer.stage("spatial_join_tme", step=(5, 8)) as info:
        df = spatial_stage.run_spatial_join(out_dir, stem, cfg, device=dev)
        info["items"] = len(df)
    with timer.stage("polygons", step=(6, 8)) as info:
        features = polygon_stage.build_polygons_for_all_classes(df, classes, cfg, device=dev)
        info["items"] = len(features)
    with timer.stage("geojson", step=(7, 8)):
        geojson_path = polygon_stage.export_geojson(features, out_dir, stem)
    return features, geojson_path

