"""Steps 2-4 of 8 — tile embeddings, class text embeddings, zero-shot
annotation.

Counterpart of the JAX package's ``pipeline/embed.py``.

Step 2, ``run_extract_features`` (ref ``extract_embedding_from_tiles.py:9-70``):
read tiles on the host in a thread pool ahead of the device, run the
image tower batched (bf16 by default) on the card, keep every batch's
features on the device until one copy at the end, and write
``<slide>_features.h5`` + the reference's torch ``.pt`` sidecar + an
``.npy`` sidecar. With the planar feed (``EmbeddingConfig.planar_feed``,
a reader with ``supports_planar``), JPEG tiles cross to the card as raw
4:2:0 planes, half the bytes of RGB, and ``ops.jpegcolor.ycbcr420_to_rgb``
finishes their decode there. With an encoder over a mesh
(``ImageEncoder(mesh=)``), the batch is rounded down to a multiple of the
mesh's shards and the feed is RGB, as in the JAX package's mesh branch.

Step 3, ``run_create_class_embeddings`` (ref ``create_embedding.py:13-69``):
tokenize the class prompts, run the text tower once, save
``<slide>_classes.npy`` + the reference's torch ``.pt``.

Step 4, ``run_annotation`` (ref ``find_annotation_from_embedding.py:9-72``):
cosine similarity tile × class on the device (f32 products, TF32 off) →
per-class score columns + ``predicted_class`` argmax →
``<slide>_annotations.csv``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd
import torch

from path_gene_multimodal_tpu_torch.config import PipelineConfig
from path_gene_multimodal_tpu_torch.core.artifacts import write_features_h5
from path_gene_multimodal_tpu_torch.io.slide import SlideReader
from path_gene_multimodal_tpu_torch.models.clip import ImageEncoder, TextEncoder
from path_gene_multimodal_tpu_torch.models.layers import product_precision
from path_gene_multimodal_tpu_torch.models.vit_timm import TimmViTConfig
from path_gene_multimodal_tpu_torch.ops.jpegcolor import ycbcr420_to_rgb
from path_gene_multimodal_tpu_torch.pipeline.tessellate import iter_tile_batches


def _is_virchow_tower(cfg: PipelineConfig, encoder) -> bool:
    """True when the image tower is the ViT-H Virchow2, judged by the
    encoder's config as well as ``cfg.model_type``: a timm Virchow2
    artifact loaded through ``--weights`` runs under whatever model_type the
    config left in place, and still gets its batch clamp and its artifact
    metadata."""
    if cfg.model_type.lower().startswith("virchow"):
        return True
    return isinstance(getattr(encoder, "cfg", None), TimmViTConfig)


def _recorded_model_type(cfg: PipelineConfig, encoder) -> str:
    """model_type written into the features artifact — the actual tower."""
    if _is_virchow_tower(cfg, encoder) and not cfg.model_type.lower().startswith("virchow"):
        return "Virchow2"
    return cfg.model_type


def _planes_to_device(planes, device: torch.device) -> list[torch.Tensor]:
    """Host planes to ``device``: pinned and non-blocking when it is a card,
    so that the copies do not wait for it."""
    out = [torch.from_numpy(p) for p in planes]
    if device.type == "cuda":
        out = [t.pin_memory() for t in out]
    return [t.to(device, non_blocking=True) for t in out]


def run_extract_features(
    slide: SlideReader,
    coords: np.ndarray,
    encoder: ImageEncoder,
    out_dir: str | Path,
    stem: str,
    cfg: PipelineConfig,
    write_artifacts: bool = True,
) -> np.ndarray:
    """Embed every tile; returns (N, D) float32. Host reads overlap device
    compute: each batch is enqueued without waiting for the card, so the
    thread pool reads batch k+1 while the card runs batch k."""
    batch = cfg.embedding.batch_size
    if _is_virchow_tower(cfg, encoder):
        # the ViT-H Virchow2 tower has its own batch (see
        # EmbeddingConfig.virchow2_batch_size) — clamp to it
        batch = min(batch, cfg.embedding.virchow2_batch_size)
    mesh = getattr(encoder, "mesh", None)
    if mesh is not None:
        # a whole number of rows a shard, rounded down as the JAX package does
        batch = max((batch // mesh.size) * mesh.size, mesh.size)
    tile = cfg.patch_size
    # RGB under a mesh: the planar route's nearest chroma differs from the
    # RGB decode's, and the JAX package's mesh branch feeds RGB
    planar = (
        mesh is None
        and cfg.embedding.planar_feed
        and tile % 2 == 0
        and getattr(slide, "supports_planar", lambda level=0: False)()
    )
    outs: list[torch.Tensor] = []
    valids: list[np.ndarray] = []
    for tiles_u8, valid in iter_tile_batches(slide, coords, tile, batch, planar=planar):
        if isinstance(tiles_u8, tuple):  # planes; a chunk may fall back to RGB
            tiles_u8 = ycbcr420_to_rgb(*_planes_to_device(tiles_u8, encoder.device))
        outs.append(encoder(tiles_u8))  # enqueued on the device
        valids.append(valid)
    if not outs:
        # width must match what the encoder would have emitted (2560 for
        # Virchow2, 768 for ViT-L/14 …) so empty-slide artifacts keep the
        # same schema as populated ones
        feats = np.zeros((0, getattr(encoder, "out_dim", 512)), np.float32)
    else:
        feats = torch.cat(outs).cpu().numpy()[np.concatenate(valids)].astype(np.float32)
    if write_artifacts:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        h5_path = out_dir / f"{stem}_features.h5"
        write_features_h5(h5_path, feats, model_type=_recorded_model_type(cfg, encoder))
        np.save(out_dir / f"{stem}_features.npy", feats)
        # reference writes the features h5 AND a torch .pt sidecar
        # (extract_embedding_from_tiles.py:70)
        torch.save(torch.from_numpy(feats), out_dir / f"{stem}_features.pt")
        if not h5_path.exists():  # output oracle (extract_embedding_from_tiles.py:61-62)
            raise RuntimeError(f"feature extraction failed to produce {h5_path}")
    return feats


def run_create_class_embeddings(
    class_names: list[str],
    text_encoder: TextEncoder,
    tokenizer,
    out_dir: str | Path,
    stem: str,
    prompt_template: str = "{}",
    write_artifacts: bool = True,
) -> np.ndarray:
    """One text embedding per class label (ref create_embedding.py:13-69).
    Returns (C, D) float32."""
    prompts = [prompt_template.format(c) for c in class_names]
    ids = tokenizer(prompts)
    embs = text_encoder(ids).cpu().numpy().astype(np.float32)
    if write_artifacts:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"{stem}_classes.npy"
        np.save(path, embs)
        # reference writes a torch .pt (create_embedding.py:65-66)
        torch.save(torch.from_numpy(embs), out_dir / f"{stem}_classes.pt")
        if not path.exists():
            raise RuntimeError(f"class-embedding step failed to produce {path}")
    return embs


def _cosine_scores(tile_embs: torch.Tensor, class_embs: torch.Tensor) -> torch.Tensor:
    """(N, D) × (C, D) → (N, C) cosine similarities in f32 (norms floored
    at 1e-8)."""
    with product_precision(torch.float32):
        a = tile_embs / torch.clamp(torch.linalg.vector_norm(tile_embs, dim=-1, keepdim=True),
                                    min=1e-8)
        b = class_embs / torch.clamp(torch.linalg.vector_norm(class_embs, dim=-1, keepdim=True),
                                     min=1e-8)
        return a @ b.t()


def run_annotation(
    tile_features: np.ndarray,
    class_embeddings: np.ndarray,
    class_names: list[str],
    out_dir: str | Path,
    stem: str,
    write_artifacts: bool = True,
    device: str | torch.device = "cuda",
) -> pd.DataFrame:
    """Cosine-similarity zero-shot annotation (ref
    find_annotation_from_embedding.py:9-72): per-class score columns +
    ``predicted_class`` argmax, the scores computed on ``device``. Returns
    the annotation frame with ``tile_index``."""
    if len(tile_features) == 0:
        raise ValueError("no tile features to annotate (empty slide?)")
    f32 = dict(dtype=torch.float32, device=device)
    scores = _cosine_scores(torch.as_tensor(np.asarray(tile_features), **f32),
                           torch.as_tensor(np.asarray(class_embeddings), **f32)).cpu().numpy()
    df = pd.DataFrame(scores, columns=list(class_names))
    df.insert(0, "tile_index", np.arange(len(df), dtype=np.int64))
    df["predicted_class"] = [class_names[i] for i in scores.argmax(axis=1)]
    if write_artifacts:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"{stem}_annotations.csv"
        df.to_csv(path, index=False)
        if not path.exists():
            raise RuntimeError(f"annotation step failed to produce {path}")
    return df
